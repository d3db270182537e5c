"""Kernel K3 (fused embed + max-pool forward): the port's plain version
against the JAX package's fused_embed_pool (Pallas, interpret mode on the
CPU) and reference_embed_pool, at rtol = atol = 1e-5, the JAX package's own
bar (tests/test_fused_embed.py)."""

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
    fused_embed_pool_fwd,
    reference_embed_pool,
    reference_embed_pool_bwd,
)

H = 64


def _inputs(seed, B, E, F):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0, loc=0.0: (
        loc + scale * rng.standard_normal(s)).astype(np.float32)
    x = f32(B, E, F)
    params = (f32(F, H, scale=0.3), f32(H, scale=0.1), f32(H, scale=0.1, loc=1.0),
              f32(H, scale=0.1), f32(H, H, scale=0.2), f32(H, scale=0.1))
    return x, params


@pytest.mark.parametrize("B,E,F", [
    (48, 37, 13),   # unaligned B, remainder entity chunk
    (32, 127, 6),   # the partner block
    (32, 200, 13),  # the road block
])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_plain_matches_jax(B, E, F, act):
    x, params = _inputs(B + E + F, B, E, F)
    tparams = [torch.from_numpy(p) for p in params]
    before = fused_embed_pool_fwd.launches
    got = fused_embed_pool(torch.from_numpy(x), *tparams, act)
    assert fused_embed_pool_fwd.launches == before  # CPU: plain version
    jparams = [jnp.asarray(p) for p in params]
    want_fused = np.asarray(jax_fused(jnp.asarray(x), *jparams,
                                      (act, "float32")))
    want_ref = np.asarray(jax_reference(jnp.asarray(x), *jparams, act=act))
    for want in (want_fused, want_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        reference_embed_pool(torch.from_numpy(x), *tparams, act).numpy(),
        want_ref, rtol=1e-5, atol=1e-5,
    )


def test_argmax_and_strided_rows():
    """The argmax indexes the winning entity wherever the top two differ,
    and a [B, E, F] view of a slice of a wider row (the flat observation)
    gives the same result as a contiguous copy."""
    B, E, F = 16, 127, 6
    x, params = _inputs(7, B, E, F)
    tparams = [torch.from_numpy(p) for p in params]
    wide = torch.zeros((B, 5 + E * F + 3))
    wide[:, 5:5 + E * F] = torch.from_numpy(x.reshape(B, -1))
    view = wide[:, 5:5 + E * F].unflatten(-1, (E, F))
    pooled, arg = fused_embed_pool_fwd(view, *tparams, "tanh")
    pooled_c, arg_c = fused_embed_pool_fwd(torch.from_numpy(x), *tparams)
    assert torch.equal(pooled, pooled_c) and torch.equal(arg, arg_c)
    assert arg.dtype == torch.int32
    w1, b1, g, be, w2, b2 = tparams
    pre = torch.from_numpy(x) @ w1 + b1
    xh = torch.nn.functional.layer_norm(pre, (H,), eps=1e-6)
    y = torch.tanh(xh * g + be) @ w2 + b2  # [B, E, H]
    top2 = y.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    picked = torch.gather(y, 1, arg.long()[:, None]).squeeze(1)
    np.testing.assert_allclose(picked.numpy(), pooled.numpy(), atol=1e-5)
    assert torch.equal(arg[clear].long(), y.argmax(dim=1)[clear])


def test_backward_is_the_training_slice():
    """The backward (K4, the training slice's kernel) runs: on CPU tensors
    it is the plain version, with the pooled cotangent sent to the forward's
    argmax, and x gets no gradient."""
    x, params = _inputs(3, 4, 5, 6)
    tparams = [torch.from_numpy(p).requires_grad_() for p in params]
    tx = torch.from_numpy(x).requires_grad_()
    out = fused_embed_pool(tx, *tparams, "tanh")
    out.sum().backward()
    assert tx.grad is None
    with torch.no_grad():
        _, arg = fused_embed_pool_fwd(tx, *tparams, "tanh")
        want = reference_embed_pool_bwd(tx, *tparams, arg, torch.ones(4, H))
    for p, w in zip(tparams, want):
        torch.testing.assert_close(p.grad, w)


def test_wrapper_rejects_bad_inputs():
    x, params = _inputs(4, 4, 5, 6)
    tparams = [torch.from_numpy(p) for p in params]
    with pytest.raises(ValueError):
        fused_embed_pool_fwd(torch.from_numpy(x), *tparams, "relu")
    with pytest.raises(TypeError):
        fused_embed_pool_fwd(torch.from_numpy(x).double(), *tparams)
    with pytest.raises(ValueError):  # w1 in torch's [out, in] layout
        fused_embed_pool_fwd(torch.from_numpy(x), tparams[0].t(),
                             *tparams[1:])
    with pytest.raises(ValueError):  # entity rows not contiguous
        fused_embed_pool_fwd(torch.from_numpy(x).transpose(1, 2), *tparams)
