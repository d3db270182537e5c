"""The yardstick's roofline arithmetic: the card's published peaks, the
least time of an amount of work, and the work of the port's kernels K1-K4
and of the late-fusion policy, counted from shapes and inputs.

Frozen copies: ``bound``, ``k2_bound`` and ``k1_bound`` of the
repository's ``chip_smoke.py``, its K3 and K4 bound expressions, and the
operation counts of the port's ``networks/fused_embed.py``
(``embed_mma_flops``, ``embed_flops``, ``bwd_flops``).  The live-pair
counts of K1 and K2 are in ``reference/sat.py``.
"""

from __future__ import annotations

# NVIDIA H100 SXM published peaks (data sheet, dense, 700 W): HBM3 bytes/s,
# fp32 operations/s outside the tensor cores (an FMA counted as two), TF32
# and bf16 tensor-core operations/s.  K1 and K2 build with --fmad=false, so
# each multiply and add is its own instruction: half the FMA rate.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_FP32_NOFMA = 33.5e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

EMBED = 64  # the late-fusion embed width (input_dim)


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0,
          fp32_peak: float = PEAK_FP32, bf16_flops: float = 0.0):
    """Least time in seconds for ``nbytes`` of traffic, ``flops`` fp32
    operations at ``fp32_peak``, ``tf32_flops`` TF32 and ``bf16_flops``
    bf16 tensor-core operations, and what sets it."""
    t_b = nbytes / PEAK_BYTES
    t_f = max(flops / fp32_peak, tf32_flops / PEAK_TF32,
              bf16_flops / PEAK_BF16)
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def k2_bound(W: int, A: int, R: int, ops: int) -> float:
    """K2's least time (s): each input read once and the output written
    once, or ``ops`` live-pair SAT operations at the no-FMA rate."""
    return bound(4 * (W * A * 8 + W * 8 * R + W * A), ops,
                 fp32_peak=PEAK_FP32_NOFMA)[0]


def k1_bound(W: int, A: int, RT: int, mask_numel: int, live_tiles: int,
             ops: int) -> float:
    """K1's least time (s): the agents, the mask, the tiles live for some
    agent block and the output, or ``ops`` at the no-FMA rate."""
    return bound(4 * (W * A * 8 + mask_numel + live_tiles * 8 * RT + W * A),
                 ops, fp32_peak=PEAK_FP32_NOFMA)[0]


def embed_mma_flops(F_in: int, H: int = EMBED) -> int:
    """Operations per entity of the embed stack's two products."""
    return 2 * F_in * H + 2 * H * H


def embed_flops(F_in: int, H: int = EMBED) -> int:
    """fp32 operations per entity of the embed stack: the two products,
    the biases and about 8*H for LayerNorm, the activation and the max."""
    return embed_mma_flops(F_in, H) + 10 * H


def bwd_flops(F_in: int, rows: int, winners: float, H: int = EMBED) -> float:
    """fp32 operations of K4 over ``rows`` rows holding ``winners``
    (row, winning entity) pairs: per winner layer 1 and dw1 and about 20*H
    for LayerNorm, the activation and their backward; per row the cotangent
    of t, dw2 and db2."""
    return winners * (4 * F_in * H + 20 * H) + rows * (4 * H * H + H)


def k3_bound(rows: int, E: int, F: int, H: int = EMBED) -> float:
    """K3's least time (s) on float32 x [rows, E, F]: x and the weights
    read once, the pooled row and its argmax written once; the products as
    3xTF32 on the tensor cores, the rest on the fp32 cores."""
    nbytes = 4 * (rows * E * F + F * H + H * H + 4 * H) + 8 * rows * H
    ent = rows * E
    mma = ent * embed_mma_flops(F, H)
    return bound(nbytes, ent * embed_flops(F, H) - mma, 3 * mma)[0]


def k4_bound(rows: int, F: int, winners: float, H: int = EMBED) -> float:
    """K4's least time (s): the winners' x, the argmax and cotangent read
    and the six gradients written once, or ``bwd_flops`` on the fp32
    cores."""
    n_out = F * H + H * H + 4 * H
    return bound(4 * (winners * F + 2 * rows * H + 2 * n_out),
                 bwd_flops(F, rows, winners, H))[0]


def late_fusion_forward_flops(ego: int, partners: int, partner_f: int,
                              roads: int, road_f: int, hidden: int,
                              actions: int, H: int = EMBED) -> int:
    """Matrix-product operations of one row of the late-fusion policy's
    forward pass: the three embed stacks (per entity), the shared layer,
    the actor and the critic."""
    return (embed_mma_flops(ego, H) + partners * embed_mma_flops(partner_f, H)
            + roads * embed_mma_flops(road_f, H) + 2 * 3 * H * hidden
            + 2 * hidden * actions + 2 * hidden)
