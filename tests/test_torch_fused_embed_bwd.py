"""Kernel K4 (fused embed + max-pool backward): on the CPU the port's
``fused_embed_pool`` differentiates through the plain version
``reference_embed_pool_bwd``.  Its parameter gradients are held against
``jax.grad`` of the JAX package's ``fused_embed_pool`` (Pallas, interpret mode
on the CPU) and of its ``reference_embed_pool``, at rtol 2e-4 and atol 2e-5,
the JAX package's own bar (tests/test_fused_embed.py).

Inputs are continuous draws, so no two entities tie for a pooled maximum:
there the port sends the cotangent to one winner (the smallest index, as
K3 picks it) while ``jnp.max`` splits it; the gradients differ only on
such exact ties.

In compute dtype bfloat16 the plain version is held against ``jax.vjp`` of
``fused_embed_pool`` with meta (act, "bfloat16") and fed the JAX forward's
argmax, so tie rules drop out (bars in ``test_plain_bf16_grads_match_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.networks.fused_embed import (
    _fused_fwd_impl as jax_fused_fwd,
    fused_embed_pool as jax_fused,
    reference_embed_pool as jax_reference,
)
from gpudrive_lab_torch.networks.fused_embed import (
    BF16_PRODUCT_BAR,
    bf16_product_error,
    bwd_product_rss,
    fused_embed_pool,
    fused_embed_pool_bwd,
    fused_embed_pool_fwd,
    reference_embed_pool_bwd,
    winner_table,
)

H = 64
NAMES = ("w1", "b1", "g", "be", "w2", "b2")


def _inputs(seed, B, E, F):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0, loc=0.0: (
        loc + scale * rng.standard_normal(s)).astype(np.float32)
    x = f32(B, E, F)
    params = (f32(F, H, scale=0.3), f32(H, scale=0.1), f32(H, scale=0.1, loc=1.0),
              f32(H, scale=0.1), f32(H, H, scale=0.2), f32(H, scale=0.1))
    return x, params, f32(B, H)


def _jax_grads(fn, x, params, co):
    jx, jco = jnp.asarray(x), jnp.asarray(co)
    grads = jax.grad(lambda *p: (fn(jx, *p) * jco).sum(),
                     argnums=tuple(range(6)))(*map(jnp.asarray, params))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,E,F,act", [
    (40, 23, 13, "tanh"),    # B not a multiple of the Pallas row tile
    (40, 23, 13, "gelu"),
    (48, 37, 13, "tanh"),    # remainder entity chunk
    (48, 37, 13, "gelu"),
    (64, 127, 6, "tanh"),    # the partner block
    (64, 200, 13, "tanh"),   # the road block
])
def test_param_grads_match_jax(B, E, F, act):
    x, params, co = _inputs(B * E + F, B, E, F)
    tx = torch.from_numpy(x).requires_grad_()
    tparams = [torch.from_numpy(p).requires_grad_() for p in params]
    before = fused_embed_pool_bwd.launches
    (fused_embed_pool(tx, *tparams, act) * torch.from_numpy(co)).sum().backward()
    assert fused_embed_pool_bwd.launches == before  # CPU: the plain version
    assert tx.grad is None  # d/dx is not computed
    got = [p.grad.numpy() for p in tparams]
    want_fused = _jax_grads(lambda x, *p: jax_fused(x, *p, (act, "float32")),
                            x, params, co)
    want_ref = _jax_grads(lambda x, *p: jax_reference(x, *p, act=act),
                          x, params, co)
    for want in (want_fused, want_ref):
        for name, a, b in zip(NAMES, got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                       err_msg=name)


def _jax_bf16_case(B, E, F, act, x_dtype):
    """The port's inputs (x stored in ``x_dtype``), the JAX forward's
    argmax and ``jax.vjp`` of the JAX op in compute dtype bfloat16."""
    x, params, co = _inputs(B * E + F + 1, B, E, F)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, x_dtype))
    jp = [jnp.asarray(p) for p in params]
    meta = (act, "bfloat16")
    _, jarg = jax_fused_fwd(jx, *jp, meta)
    _, vjp = jax.vjp(lambda *p: jax_fused(jx, *p, meta), *jp)
    want = [np.asarray(g) for g in vjp(jnp.asarray(co))]
    args = (tx, *[torch.from_numpy(p) for p in params],
            torch.from_numpy(np.array(jarg)), torch.from_numpy(co))
    return args, want


BF16_CASES = [
    (40, 23, 13, "tanh"),    # B not a multiple of the Pallas row tile
    (40, 23, 13, "gelu"),
    (64, 127, 6, "tanh"),    # the partner block
    (64, 200, 13, "gelu"),   # the road block
]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,E,F,act", BF16_CASES)
def test_plain_bf16_grads_match_jax(B, E, F, act, x_dtype):
    """Compute dtype bfloat16.  db1, dg, dbe and db2 sum unrounded float32
    values, which the two sides add in another order: the JAX package's
    float32 bar above.  dw1 and dw2 sum products of operands rounded to
    bf16 (dpre and t), which the two sides can round apart where a float32
    value lies within a few ulps of a rounding boundary: their error, as a
    share of the terms' root-sum-square, is held at
    ``BF16_PRODUCT_BAR`` = 2^-12 (derived in fused_embed.py; 4.7e-7 to
    3.4e-5 here, while a version that skips a rounding reads 1.4e-3 to
    1.7e-3: ``test_bf16_bar_rejects_a_missing_rounding``)."""
    args, want = _jax_bf16_case(B, E, F, act, x_dtype)
    before = fused_embed_pool_bwd.launches
    got = fused_embed_pool_bwd(*args, act, torch.bfloat16)
    assert fused_embed_pool_bwd.launches == before  # CPU: the plain version
    rss = bwd_product_rss(*args, act, torch.bfloat16)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        if name in ("w1", "w2"):
            err = bf16_product_error(a, torch.tensor(b),
                                     rss[name == "w2"])
            assert err <= BF16_PRODUCT_BAR, (name, err)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("control", ["t", "dpre", "float32"])
@pytest.mark.parametrize("B,E,F,act", BF16_CASES)
def test_bf16_bar_rejects_a_missing_rounding(B, E, F, act, control):
    """The controls of the bar above: the plain backward with t (dw2's
    operand) or dpre (dw1's) left unrounded, or computed in float32, against
    the same JAX gradients, must exceed ``BF16_PRODUCT_BAR`` on the
    gradient whose rounding it skips, while the sound version stays within
    it on both."""
    args, want = _jax_bf16_case(B, E, F, act, "bfloat16")
    rss = bwd_product_rss(*args, act, torch.bfloat16)
    if control == "float32":
        got = reference_embed_pool_bwd(*args, act, torch.float32)
        skipped = ("w1", "w2")
    else:
        got = reference_embed_pool_bwd(*args, act, torch.bfloat16,
                                       unrounded=(control,))
        skipped = ("w2",) if control == "t" else ("w1",)
    for name in skipped:
        i = NAMES.index(name)
        err = bf16_product_error(got[i], torch.tensor(want[i]),
                                 rss[name == "w2"])
        assert err > BF16_PRODUCT_BAR, (name, err)


def test_padding_rows_send_no_gradient():
    """Rows whose winner is -1 (or out of range) contribute nothing: the
    gradients equal those of the real rows alone, up to float32 sums taken
    in another order."""
    B, E, F = 24, 31, 13
    x, params, co = _inputs(5, B, E, F)
    tx, tco = torch.from_numpy(x), torch.from_numpy(co)
    tparams = [torch.from_numpy(p) for p in params]
    _, arg = fused_embed_pool_fwd(tx, *tparams)
    padded = arg.clone()
    padded[16:20] = -1
    padded[20:] = E
    got = fused_embed_pool_bwd(tx, *tparams, padded, tco)
    want = reference_embed_pool_bwd(tx[:16], *tparams, arg[:16], tco[:16])
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_bwd_wrapper_rejects_bad_inputs():
    x, params, co = _inputs(6, 4, 5, 6)
    tx, tco = torch.from_numpy(x), torch.from_numpy(co)
    tparams = [torch.from_numpy(p) for p in params]
    _, arg = fused_embed_pool_fwd(tx, *tparams)
    with pytest.raises(ValueError):  # argmax must be int32
        fused_embed_pool_bwd(tx, *tparams, arg.long(), tco)
    with pytest.raises(ValueError):  # dpool of the wrong width
        fused_embed_pool_bwd(tx, *tparams, arg, tco[:, :32])
    with pytest.raises(ValueError):
        fused_embed_pool_bwd(tx, *tparams, arg, tco, "relu")


def _winner_table_numpy(argmax, E):
    """Each row's distinct winners in order of their first unit: the count
    and, per unit, its winner's position in that order (-1 for none)."""
    count = np.zeros(argmax.shape[0], np.int64)
    rank = np.full(argmax.shape, -1, np.int64)
    for b, row in enumerate(argmax):
        seen = {}
        for j, e in enumerate(row):
            if 0 <= e < E:
                rank[b, j] = seen.setdefault(int(e), len(seen))
        count[b] = len(seen)
    return count, rank


@pytest.mark.parametrize("E,seed", [(1, 0), (5, 1), (200, 2)])
def test_winner_table_matches_numpy(E, seed):
    """The plain version of K4's winner step: ranks in order of first
    appearance, out-of-range units (-1, E) without a winner."""
    rng = np.random.default_rng(seed)
    argmax = rng.integers(-1, E + 1, size=(40, H)).astype(np.int32)
    argmax[0] = 3 % E   # one winner for the whole row
    argmax[1] = -1      # a padding row: no winner
    count, rank = winner_table(torch.from_numpy(argmax), E)
    want_count, want_rank = _winner_table_numpy(argmax, E)
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    assert count[0] == 1 and count[1] == 0
