"""The matrix-product operations of one VBD sample at the released
checkpoint's architecture, counted from the published widths and the
cell's shapes (a multiply-add counted as two).

What ``sample_official`` runs through a product: the encoder once (the
agent GRU over the history, the map's point MLP, the Fourier relation MLPs
over every token pair, the QCMHA stack with its relative terms in the
logits and the values) and the denoiser at each diffusion step (the
trajectory embedding, two agent-attention and two scene-attention blocks
with their key and value projections over every agent's keys, their FFNs,
the decoder head).  The goal predictor is not called; the roll-out, the
scheduler and the env's steps have no products.  The count matches
``torch.utils.flop_counter.FlopCounterMode`` on the port's model
(``benchmark/tests/test_bench_vbd.py``).
"""

from __future__ import annotations

GRU_IN = 8  # agent history features
POINT_IN, POINT_HIDDEN = 3, 128  # the map's point MLP
RELATION_DIMS, BANDS = 3, 64  # Fourier features: per dimension 2 * 64 + 1
TRAJ_IN, TRAJ_HIDDEN = 5, 128  # the denoiser's trajectory embedding
HEAD_HIDDEN, HEAD_OUT = 128, 2  # the decoder head


def linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def encoder_flops(model: dict, agents: int, polylines: int, points: int,
                  lights: int, history: int) -> int:
    """One world's encoder: S = agents + polylines + lights tokens."""
    D, F = model["hidden_dim"], model["ffn_dim"]
    S = agents + polylines + lights
    gru = history * agents * (linear(1, GRU_IN, 3 * D) + linear(1, D, 3 * D)
                              + 2 * linear(1, D, 3 * D))
    points_mlp = (linear(polylines * points, POINT_IN, POINT_HIDDEN)
                  + linear(polylines * points, POINT_HIDDEN, D))
    pairs = S * S
    fourier = (RELATION_DIMS * (linear(pairs, 2 * BANDS + 1, D)
                                + linear(pairs, D, D))
               + linear(pairs, D, D))
    layer = (linear(S, D, 3 * D) + linear(S, D, D) + linear(S, D, F)
             + linear(S, F, D)
             # q.k, q.r, a.v and a.r over every (query, key) pair
             + 4 * 2 * pairs * D)
    return gru + points_mlp + fourier + model["encoder_layers"] * layer


def denoise_flops(model: dict, agents: int, tokens: int) -> int:
    """One world's denoiser call: ``agents`` x T queries; the agent blocks
    attend over every agent's T keys, the scene blocks over the
    ``tokens`` scene tokens (each agent's own copy of the keys, projected
    once for K and once for V)."""
    D, F = model["hidden_dim"], model["ffn_dim"]
    T = model["future_len"] // model["action_len"]
    Q = agents * T

    def block(keys: int) -> int:
        return (linear(Q, D, D) + 2 * linear(agents * keys, D, D)
                + 2 * 2 * Q * keys * D  # logits and the weighted values
                + linear(Q, D, D) + linear(Q, D, F) + linear(Q, F, D))

    embed = (linear(Q * model["action_len"], TRAJ_IN, TRAJ_HIDDEN)
             + linear(Q * model["action_len"], TRAJ_HIDDEN, D))
    head = linear(Q, D, HEAD_HIDDEN) + linear(Q, HEAD_HIDDEN, HEAD_OUT)
    return embed + 2 * block(Q) + 2 * block(tokens) + head


def sample_flops(model: dict, worlds: int, polylines: int, points: int,
                 lights: int, history: int) -> int:
    """Matrix-product operations of one sample over ``worlds`` worlds: the
    encoder once and the denoiser ``diffusion_steps`` times."""
    A = model["agents_len"]
    S = A + polylines + lights
    return worlds * (encoder_flops(model, A, polylines, points, lights,
                                   history)
                     + model["diffusion_steps"] * denoise_flops(model, A, S))
