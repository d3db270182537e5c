"""The precision choice of kernel K3: 3xTF32 on the tensor cores.

K3 runs its two products as TF32 tensor-core products.  TF32 keeps 10
mantissa bits, so K3 splits each operand v into hi = tf32(v) and
lo = tf32(v - hi) and sums lo*hi + hi*lo + hi*hi in fp32 (the tf32 x tf32
products are exact in fp32).  These tests emulate that arithmetic in plain
torch, rounding through an int32 view as cvt.rna.tf32.f32 does, on real
observations of data/pool_v3 through the slice policy's weights, and hold
it to K3's bars on the card against ``reference_embed_pool_argmax``:
pooled max abs error <= 1e-4, and the argmax equal wherever the top two
values differ by more than 1e-5.  One TF32 pass breaks the argmax bar,
which is why K3 takes three.

K3's bf16 compute mode (K3-bf16, csrc/fused_embed_bf16.cu) runs native bf16
wgmma; one TF32 pass over operands rounded to bf16 is the other exact route
to the same products.  The last tests check, with the same emulation, that
bf16 values are fixed points of the TF32 rounding and that one emulated
TF32 pass over bf16-rounded operands gives the plain bf16 version's bits
on the same real observations.
"""

import os

import numpy as np
import pytest
import torch

from gpudrive_lab_torch.networks import fused_embed as fe
from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env, slice_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), kept as
    float32: add half of the dropped range to the magnitude bits and clear
    the low 13 mantissa bits."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a, b, bias, passes: int):
    """bias + a @ b as K3 takes it: 3 passes (lo*hi, hi*lo, hi*hi) or one
    (hi*hi), each summed in fp32."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return bias + ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return bias + al @ bh + ah @ bl + ah @ bh


def embed_tf32(x, w1, b1, g, be, w2, b2, passes: int):
    """The embed stack with both products in TF32 and the rest in fp32."""
    pre = product(x, w1, b1, passes)
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    xh = (pre - mu) * torch.rsqrt(var + fe.LN_EPS)
    return product(torch.tanh(xh * g + be), w2, b2, passes)


@pytest.fixture(scope="module")
def blocks():
    """The partner [512, 127, 6] and road [512, 200, 13] blocks of 4 pool
    worlds' observations after 3 random steps, with the slice policy's
    weights (seed 0), as K3 receives them."""
    env = slice_env(pool_scene_paths(ROOT)[:4], device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (env.num_worlds, env.max_agent_count),
            generator=gen))
    flat = env.get_obs().reshape(-1, 3368)
    policy = slice_policy(device="cpu", seed=0)
    out = {}
    for name, emb, x in (
            ("partner", policy.partner_embed,
             flat[:, 6:768].unflatten(-1, (127, 6))),
            ("road", policy.road_map_embed,
             flat[:, 768:].unflatten(-1, (200, 13)))):
        lin1, ln, _, _, lin2 = emb
        w = tuple(t.detach() for t in (
            lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
            lin2.weight.t().contiguous(), lin2.bias))
        out[name] = (x.contiguous(), w)
    return out


def _bars(x, w, passes):
    """(pooled max abs error, argmax mismatches where the gap > 1e-5,
    units with such a gap) of the emulation against the plain version."""
    with torch.no_grad():
        want, _ = fe.reference_embed_pool_argmax(x, *w)
        y = fe._embed(x, *w, "tanh")
        top2 = y.topk(2, dim=1)
        clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
        pooled, arg = embed_tf32(x, *w, passes).max(dim=1)
    err = float((pooled - want).abs().max())
    wrong = int((arg != top2.indices[:, 0])[clear].sum())
    return err, wrong, int(clear.sum())


@pytest.mark.parametrize("name", ["partner", "road"])
def test_three_tf32_passes_meet_k3_bars(blocks, name):
    x, w = blocks[name]
    err, wrong, clear = _bars(x, w, passes=3)
    assert clear > 1000  # enough units with a clear winner to mean something
    assert err <= 1e-4
    assert wrong == 0


@pytest.mark.parametrize("name", ["partner", "road"])
def test_one_tf32_pass_breaks_the_argmax_bar(blocks, name):
    x, w = blocks[name]
    _, wrong, _ = _bars(x, w, passes=1)
    assert wrong > 0


def embed_tf32_over_bf16(x, w1, b1, g, be, w2, b2):
    """The bf16 mode by one TF32 pass: the operands of both products
    rounded to bf16, then one emulated TF32 pass, the rest in fp32."""
    r = fe.round_bf16
    pre = product(r(x.float()), r(w1), b1, passes=1)
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    xh = (pre - mu) * torch.rsqrt(var + fe.LN_EPS)
    return product(r(torch.tanh(xh * g + be)), r(w2), b2, passes=1)


def test_bf16_values_are_tf32_fixed_points():
    """TF32 keeps 10 mantissa bits and bf16 7: rounding a bf16 value to
    TF32 changes no bit, for normal, subnormal, huge and signed values and
    for the halfway cases of the bf16 rounding itself."""
    r = torch.randn(100000, generator=torch.Generator().manual_seed(2))
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -8,
                            1.0 + 3 * 2.0 ** -8, 3.0e38, -3.0e38, 1.0e-39,
                            1.2e-38, 65504.0, 2.0 ** -126])
    for v in (r, r * 1e4, r * 1e-30, special):
        b = fe.round_bf16(v)
        assert torch.equal(tf32(b).view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", ["partner", "road"])
def test_one_tf32_pass_over_bf16_operands_is_the_bf16_mode(blocks, name):
    """On the real pool blocks with the slice policy's weights, one
    emulated TF32 pass over bf16-rounded operands gives the bits of the
    plain version of K3's bf16 mode (reference_embed_pool_argmax with
    compute_dtype bfloat16), x stored in float32 or bf16."""
    x, w = blocks[name]
    with torch.no_grad():
        pooled, arg = embed_tf32_over_bf16(x, *w).max(dim=1)
        for xs in (x, x.to(torch.bfloat16)):
            want, want_arg = fe.reference_embed_pool_argmax(
                xs, *w, "tanh", torch.bfloat16)
            assert torch.equal(pooled, want)
            assert torch.equal(arg.to(torch.int32), want_arg)


def test_tf32_rounding():
    """Round to nearest on the low 13 mantissa bits, ties away from zero;
    the split is exact to ~2^-22 relative."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    v = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0], dtype=torch.float32)
    want = torch.tensor([one, one, one + ulp, one + ulp, -(one + ulp), 3.0])
    assert torch.equal(tf32(v), want)
    r = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    hi = tf32(r)
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(((r - hi - tf32(r - hi)).abs() / r.abs()).max()) <= 2.0 ** -21
