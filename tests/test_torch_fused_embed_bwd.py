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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.networks.fused_embed import (
    fused_embed_pool as jax_fused,
    reference_embed_pool as jax_reference,
)
from gpudrive_lab_torch.networks.fused_embed import (
    fused_embed_pool,
    fused_embed_pool_bwd,
    fused_embed_pool_fwd,
    reference_embed_pool_bwd,
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
