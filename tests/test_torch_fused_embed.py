"""Kernel K3 (fused embed + max-pool forward): the port's plain version
against the JAX package's fused_embed_pool (Pallas, interpret mode on the
CPU) and reference_embed_pool, at rtol = atol = 1e-5, the JAX package's own
bar (tests/test_fused_embed.py); and in compute dtype bfloat16 against
fused_embed_pool with meta (act, "bfloat16"), at the bars stated below."""

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
    _embed,
    bf16_flip_bound,
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


# Bars of the bf16 compute dtype.  Both sides compute the products of
# bf16-rounded operands exactly and sum them in float32, in another order,
# so the float32 values they round to bf16 (the activation output t before
# layer 2) agree to a few ulps; where one lies that close to a bf16
# rounding boundary the two round it apart, a flip that moves y by at most
# bf16_flip_bound (one bf16 ulp of t, <= 2^-7 |t|, times max |w2|).  Bars:
# every pooled entry within BF16_FLIPS flips, at most 1% of the entries
# beyond 1e-5 (the sum order alone moves them by ~1e-6), and the argmax
# equal wherever the top two differ by more than twice that bar.
BF16_FLIPS = 4


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,E,F", [
    (48, 37, 13),   # E not a multiple of 16, unaligned B
    (32, 127, 6),   # the partner block
    (32, 200, 13),  # the road block
])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_plain_bf16_matches_jax(B, E, F, act, x_dtype):
    x, params = _inputs(B + E + F + 1, B, E, F)
    tparams = [torch.from_numpy(p) for p in params]
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, x_dtype))
    before = fused_embed_pool_fwd.launches
    got, arg = fused_embed_pool_fwd(tx, *tparams, act, torch.bfloat16)
    assert fused_embed_pool_fwd.launches == before  # CPU: plain version
    want, jarg = (np.asarray(v) for v in jax_fused_fwd(
        jx, *map(jnp.asarray, params), (act, "bfloat16")))
    bar = BF16_FLIPS * bf16_flip_bound(act, *tparams[2:5])
    err = np.abs(got.numpy() - want)
    assert err.max() <= bar, (err.max(), bar)
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).sum()
    y = _embed(tx, *tparams, act, torch.bfloat16)
    top2 = y.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * bar).numpy()
    assert clear.sum() >= 50  # enough clear units to mean something
    np.testing.assert_array_equal(arg.numpy()[clear], jarg[clear])
    np.testing.assert_array_equal(
        fused_embed_pool(tx, *tparams, act, torch.bfloat16).numpy(),
        got.numpy())


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


def test_wrapper_checks_the_compute_dtype():
    """x may be bfloat16 only in compute dtype bfloat16; the parameters are
    float32 in both; other compute dtypes are refused."""
    x, params = _inputs(5, 4, 5, 6)
    tparams = [torch.from_numpy(p) for p in params]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.raises(TypeError):
        fused_embed_pool_fwd(xb, *tparams)
    with pytest.raises(TypeError):
        fused_embed_pool_fwd(xb, *[t.to(torch.bfloat16) for t in tparams],
                             "tanh", torch.bfloat16)
    with pytest.raises(ValueError):
        fused_embed_pool_fwd(torch.from_numpy(x), *tparams, "tanh",
                             torch.float16)
    got, _ = fused_embed_pool_fwd(xb, *tparams, "tanh", torch.bfloat16)
    want, _ = fused_embed_pool_fwd(xb.float(), *tparams, "tanh",
                                   torch.bfloat16)
    assert got.dtype == torch.float32 and torch.equal(got, want)
