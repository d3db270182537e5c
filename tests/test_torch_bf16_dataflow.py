"""The dataflow of K3-bf16 and K4-bf16, emulated in plain torch.

K3-bf16 (csrc/fused_embed_bf16.cu) runs both products on bf16 wgmma
m64n64k16 with A in registers.  Per warp, the A fragment of k-step kk holds
register r = (row g + 8 (r % 2), columns 16 kk + 2q + 8 (r // 2) + {0, 1}),
two bf16 to a register with the lower column in the low half, and the f32
accumulator of n-tile nt holds element i = (row g + 8 (i // 2), column
8 nt + 2q + i % 2), where g = lane // 4 and q = lane % 4.  The kernel packs
the layer-1 accumulators of n-tiles 2kk and 2kk + 1, after LayerNorm and the
activation, straight into layer 2's A fragment of k-step kk.  The first
tests check those index maps and the weights' shared-memory layout, then
run the real pool observations through the slice policy's weights with
every matrix taken apart into fragments and put back by the maps: the
result is ``reference_embed_pool_argmax(..., torch.bfloat16)`` bit for bit.

K4-bf16 (csrc/fused_embed_bwd_bf16.cu) makes each chunk's winners into
dense matrices: Xw (their x), dY (dpool at the units each won) and three
products of bf16 operands with f32 sums, dT = dY w2^T, dw2 += t^T dY and
dw1 += Xw^T dpre.  ``dense_winner_bwd`` is that formulation as matmuls of
bf16-valued float32 operands; it is held against the JAX package's bf16
``_fused_bwd`` (run as the JAX tests run it on the CPU) at the bars of
tests/test_torch_fused_embed_bwd.py, and the variants that leave t or dpre
unrounded are shown to fail them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.networks.fused_embed import (
    _fused_fwd_impl as jax_fused_fwd,
    fused_embed_pool as jax_fused,
)
from gpudrive_lab_torch.networks import fused_embed as fe
from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env, slice_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 64
LANES = torch.arange(32)
G, Q = LANES // 4, LANES % 4
NAMES = ("w1", "b1", "g", "be", "w2", "b2")


def acc_map():
    """(row, col) [32, 8, 4] of accumulator element (lane, nt, i) in a
    warp's 16 x 64 block."""
    nt, i = torch.arange(8)[None, :, None], torch.arange(4)[None, None, :]
    row = G[:, None, None] + 8 * (i // 2)
    col = 8 * nt + 2 * Q[:, None, None] + i % 2
    return row.expand(32, 8, 4), col.expand(32, 8, 4)


def a_map(k_steps):
    """(row, col) [32, k_steps, 4, 2] of the A fragment's element (lane,
    k-step kk, register r, half h): h = 0 is the register's low half."""
    kk = torch.arange(k_steps)[None, :, None, None]
    r = torch.arange(4)[None, None, :, None]
    h = torch.arange(2)[None, None, None, :]
    row = G[:, None, None, None] + 8 * (r % 2)
    col = 16 * kk + 2 * Q[:, None, None, None] + 8 * (r // 2) + h
    shape = (32, k_steps, 4, 2)
    return row.expand(shape), col.expand(shape)


def bf16_bits(v):
    """v rounded to bf16 (nearest, ties to even), as int32 bits 0..65535."""
    return v.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def from_bits(b):
    """int32 bf16 bits -> float32."""
    return (b << 16).view(torch.float32)


def to_a_fragments(m, k_steps):
    """A matrix [..., 16, 16 k_steps] (float32) -> the packed registers
    [..., 32, k_steps, 4] as K3-bf16 builds them."""
    row, col = a_map(k_steps)
    v = bf16_bits(m[..., row, col])
    return v[..., 0] | (v[..., 1] << 16)


def from_a_fragments(regs, k_steps):
    """The inverse: packed registers -> the bf16-valued [..., 16, 16 k]."""
    row, col = a_map(k_steps)
    out = torch.zeros(regs.shape[:-3] + (16, 16 * k_steps))
    halves = torch.stack([regs & 0xFFFF, (regs >> 16) & 0xFFFF], dim=-1)
    out[..., row, col] = from_bits(halves)
    return out


def pack_accumulators(acc):
    """The kernel's packing of a finished layer-1 accumulator [..., 32, 8, 4]
    into layer 2's A registers [..., 32, 4, 4]: k-step kk takes n-tiles 2kk
    (registers 0, 1) and 2kk + 1 (registers 2, 3), rows g then g + 8."""
    b = bf16_bits(acc)
    regs = []
    for kk in range(4):
        for h in range(2):
            nt = 2 * kk + h
            regs.append(b[..., nt, 0] | (b[..., nt, 1] << 16))
            regs.append(b[..., nt, 2] | (b[..., nt, 3] << 16))
    return torch.stack(regs, dim=-1).unflatten(-1, (4, 4))


def test_accumulator_fragments_are_the_next_a_fragments():
    """Element h of register r of layer 2's k-step kk sits where n-tile
    2kk + r // 2 of the accumulator keeps its element 2 (r % 2) + h, for
    every lane, and both maps cover the warp's 16 x 64 block once."""
    arow, acol = acc_map()
    frow, fcol = a_map(4)
    for kk in range(4):
        for r in range(4):
            for h in range(2):
                nt, i = 2 * kk + r // 2, 2 * (r % 2) + h
                assert torch.equal(frow[:, kk, r, h], arow[:, nt, i])
                assert torch.equal(fcol[:, kk, r, h], acol[:, nt, i])
    for row, col in ((arow, acol), (frow, fcol)):
        cells = (row * 64 + col).flatten()
        assert torch.equal(cells.sort().values, torch.arange(16 * 64))


def test_packing_follows_the_index_maps():
    """pack_accumulators (the kernel's order of registers) equals reading the
    accumulator's matrix through the A-fragment map."""
    m = torch.randn(3, 16, 64, generator=torch.Generator().manual_seed(4))
    arow, acol = acc_map()
    assert torch.equal(pack_accumulators(m[:, arow, acol]),
                       to_a_fragments(m, 4))


def test_weight_tiles_match_the_descriptor():
    """w1 and w2 sit in shared memory as K-major core matrices of 8 n-rows
    x 8 k (16 bytes a row), core (n / 8, k / 8) at n / 8 * 2 + k / 8: the
    no-swizzle layout the descriptor names with LBO = 128 bytes between the
    two cores of a k16 step and SBO = 256 bytes between groups of 8 n."""
    k, n = torch.meshgrid(torch.arange(16), torch.arange(64), indexing="ij")
    core_offset = ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8
    byte = (n // 8) * 256 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    assert torch.equal(2 * core_offset, byte)
    assert torch.equal(core_offset.flatten().sort().values,
                       torch.arange(16 * 64))


@pytest.fixture(scope="module")
def blocks():
    """The partner [512, 127, 6] and road [512, 200, 13] blocks of 4 pool
    worlds' observations after 3 random steps, with the slice policy's
    weights (seed 0), as the kernels receive them."""
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


def _tiles(m, E):
    """[B, E, C] -> [B, T, 16, C] tiles of 16 entities, zero past E."""
    B, _, C = m.shape
    T = -(-E // 16)
    pad = torch.zeros(B, T * 16, C)
    pad[:, :E] = m
    return pad.unflatten(1, (T, 16))


def k3_bf16_dataflow(x, w1, b1, g, be, w2, b2):
    """The plain bf16 forward with every product's A operand taken apart
    into K3-bf16's register fragments and put back, and layer 2's A built
    from the layer-1 accumulator fragments by the kernel's packing."""
    B, E, F = x.shape
    r = fe.round_bf16
    # layer 1: x's fragments, features zero-padded to one k16 step
    xt = _tiles(torch.nn.functional.pad(x.float(), (0, 16 - F)), E)
    xa = from_a_fragments(to_a_fragments(xt, 1), 1).flatten(1, 2)[:, :E]
    assert torch.equal(xa[..., :F], r(x.float()))
    assert not xa[..., F:].any()
    pre = xa[..., :F] @ r(w1) + b1
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    t = torch.tanh((pre - mu) * torch.rsqrt(var + fe.LN_EPS) * g + be)
    # t as accumulator fragments, packed into layer 2's A fragments
    arow, acol = acc_map()
    acc = _tiles(t, E)[:, :, arow, acol]
    ta = from_a_fragments(pack_accumulators(acc), 4).flatten(1, 2)[:, :E]
    assert torch.equal(ta, r(t))
    return ta @ r(w2) + b2


@pytest.mark.parametrize("name", ["partner", "road"])
def test_k3_bf16_dataflow_gives_the_plain_bits(blocks, name):
    """On the real pool blocks, the fragment dataflow gives the pooled
    output and argmax of the plain bf16 version bit for bit, x stored in
    float32 or bf16."""
    x, w = blocks[name]
    with torch.no_grad():
        for xs in (x, x.to(torch.bfloat16)):
            pooled, arg = k3_bf16_dataflow(xs, *w).max(dim=1)
            want, want_arg = fe.reference_embed_pool_argmax(
                xs, *w, "tanh", torch.bfloat16)
            assert torch.equal(pooled.view(torch.int32),
                               want.view(torch.int32))
            assert torch.equal(arg.to(torch.int32), want_arg)


def dense_winner_bwd(x, w1, b1, g, be, w2, b2, argmax, dpool, act="tanh",
                     unrounded=()):
    """K4-bf16's formulation: the winners of all rows as the rows of dense
    matrices.  Xw [N, F] (x of each row's distinct winners, in order of
    their first unit), dY [N, 64] (dpool where the winner won the unit),
    and the products dT = dY w2^T, dw2 = t^T dY, dw1 = Xw^T dpre on
    operands rounded to bf16; db1, dg, dbe and db2 sum unrounded float32.
    ``unrounded`` ("t", "dpre") leaves that operand unrounded."""
    B, E, F = x.shape
    r = fe.round_bf16
    keep = {n: (lambda v: v) if n in unrounded else r for n in ("t", "dpre")}
    count, rank = fe.winner_table(argmax, E)
    ent = torch.zeros(B, H, dtype=torch.long)  # entity of rank k in row b
    ok = rank >= 0
    ent[torch.nonzero(ok, as_tuple=True)[0], rank[ok]] = argmax[ok].long()
    rows, ranks = torch.nonzero(torch.arange(H) < count[:, None],
                                as_tuple=True)
    xw = r(x[rows, ent[rows, ranks]].float())
    pre = xw @ r(w1) + b1
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + fe.LN_EPS)
    xh = (pre - mu) * rstd
    lin = xh * g + be
    t = fe._act(lin, act)
    dy = torch.where(rank[rows] == ranks[:, None], dpool[rows], 0.0)
    dlin = (r(dy) @ r(w2).t()) * fe._act_grad(lin, t, act)
    dxh = dlin * g
    dpre = (dxh - dxh.mean(dim=-1, keepdim=True)
            - xh * (dxh * xh).mean(dim=-1, keepdim=True)) * rstd
    return (xw.t() @ keep["dpre"](dpre), dpre.sum(0), (dlin * xh).sum(0),
            dlin.sum(0), keep["t"](t).t() @ r(dy), dy.sum(0))


ROWS = 64  # rows of each real block held against the JAX backward


def _jax_bf16_grads(x, w, act, seed):
    """The JAX package's bf16 argmax and parameter gradients (jax.vjp of
    ``fused_embed_pool`` with meta (act, "bfloat16")) on the same inputs,
    and the pooled cotangent drawn with numpy."""
    co = np.random.default_rng(seed).standard_normal(
        (x.shape[0], H)).astype(np.float32)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    jp = [jnp.asarray(p.numpy()) for p in w]
    meta = (act, "bfloat16")
    _, jarg = jax_fused_fwd(jx, *jp, meta)
    _, vjp = jax.vjp(lambda *p: jax_fused(jx, *p, meta), *jp)
    want = [torch.from_numpy(np.array(v)) for v in vjp(jnp.asarray(co))]
    return torch.from_numpy(np.array(jarg)), torch.from_numpy(co), want


def _errors(x, w, arg, co, got, want, act):
    """{gradient: error}: dw1, dw2 as a share of their terms' root-sum-
    square, the others as max abs error over the JAX bar's allowance."""
    rss = fe.bwd_product_rss(x, *w, arg, co, act, torch.bfloat16)
    out = {}
    for name, a, b in zip(NAMES, got, want):
        if name in ("w1", "w2"):
            out[name] = fe.bf16_product_error(a, b, rss[name == "w2"])
        else:
            out[name] = float(((a - b).abs() / (2e-5 + 2e-4 * b.abs())).max())
    return out


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["partner", "road"])
def test_dense_winner_bwd_matches_jax(blocks, name, x_dtype):
    """The dense-winner formulation on real pool rows against the JAX
    package's bf16 backward: dw1 and dw2 within BF16_PRODUCT_BAR of their
    terms' root-sum-square, the float32 sums at rtol 2e-4, atol 2e-5."""
    x, w = blocks[name]
    x = x[:ROWS].to(getattr(torch, x_dtype))
    arg, co, want = _jax_bf16_grads(x, w, "tanh", seed=7)
    with torch.no_grad():
        got = dense_winner_bwd(x, *w, arg, co)
        err = _errors(x, w, arg, co, got, want, "tanh")
    for n in ("w1", "w2"):
        assert err[n] <= fe.BF16_PRODUCT_BAR, (n, err)
    for n in ("b1", "g", "be", "b2"):
        assert err[n] <= 1.0, (n, err)


@pytest.mark.parametrize("control", ["t", "dpre"])
@pytest.mark.parametrize("name", ["partner", "road"])
def test_dense_winner_bar_rejects_a_missing_rounding(blocks, name, control):
    """The same formulation with t (dw2's operand) or dpre (dw1's) left
    unrounded exceeds BF16_PRODUCT_BAR on the gradient it skips."""
    x, w = blocks[name]
    x = x[:ROWS].to(torch.bfloat16)
    arg, co, want = _jax_bf16_grads(x, w, "tanh", seed=7)
    with torch.no_grad():
        got = dense_winner_bwd(x, *w, arg, co, unrounded=(control,))
        err = _errors(x, w, arg, co, got, want, "tanh")
    skipped = "w2" if control == "t" else "w1"
    assert err[skipped] > fe.BF16_PRODUCT_BAR, (skipped, err)


@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_dense_winner_bwd_is_the_plain_bwd(act):
    """With the plain backward's own argmax and draws, the dense formulation
    and ``reference_embed_pool_bwd`` in bf16 agree to float32 sum order:
    only the winners carry a gradient, and padding winners (-1, E) none."""
    rng = np.random.default_rng(11)
    B, E, F = 40, 23, 13
    x = torch.from_numpy(rng.standard_normal((B, E, F)).astype(np.float32))
    w = [torch.from_numpy(v.astype(np.float32)) for v in (
        0.3 * rng.standard_normal((F, H)), 0.1 * rng.standard_normal(H),
        1 + 0.1 * rng.standard_normal(H), 0.1 * rng.standard_normal(H),
        0.2 * rng.standard_normal((H, H)), 0.1 * rng.standard_normal(H))]
    co = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    _, arg = fe.reference_embed_pool_argmax(x, *w, act, torch.bfloat16)
    arg[30:35] = -1
    arg[35:] = E
    got = dense_winner_bwd(x, *w, arg, co, act)
    want = fe.reference_embed_pool_bwd(x, *w, arg, co, act, torch.bfloat16)
    rss = fe.bwd_product_rss(x, *w, arg, co, act, torch.bfloat16)
    for name, a, b in zip(NAMES, got, want):
        if name in ("w1", "w2"):
            assert fe.bf16_product_error(a, b, rss[name == "w2"]) <= \
                fe.BF16_PRODUCT_BAR, name
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
