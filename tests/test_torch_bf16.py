"""The bf16 policy dtype of the port on the CPU:

  * ``LateFusionPolicy`` with ``PolicyConfig(dtype=torch.bfloat16)``, fused
    and unfused, against flax's ``LateFusionPolicy(PolicyConfig(
    dtype=jnp.bfloat16))`` from the same weights: logits, value and the
    gradient of a scalar loss;
  * the JAX package's own bf16 contract (tests/test_ppo.py,
    ``test_bf16_policy_dtype_trains_close_to_f32``) mirrored: one bf16
    iteration stays close to the float32 one;
  * the unfused bf16 pool's gradient against the exact sum of its
    cotangent where bf16 maxima tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.networks.late_fusion import (
    LateFusionPolicy as FlaxPolicy,
    PolicyConfig as FlaxPolicyConfig,
)
from gpudrive_lab_torch.networks.convert import params_from_flax
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.train import build_trainer
from gpudrive_lab_torch.rollout import slice_env
from torch_parity import POOL_SCENES, flax_variables


@pytest.mark.parametrize("act,fused,obs_dtype", [
    ("tanh", False, "float32"),
    ("tanh", True, "float32"),
    ("tanh", True, "bfloat16"),   # a bf16 observation store
    ("gelu", False, "float32"),
    ("gelu", True, "float32"),
])
def test_bf16_policy_matches_flax(act, fused, obs_dtype):
    """Logits and value within two bf16 ulps of their largest magnitude:
    the forwards run the same bf16 operations (flax's Dense, LayerNorm and
    activations, mirrored op by op), and only the fused blocks' float32
    sums (K3's plain version against the Pallas kernel) come in another
    order, which can flip the bf16 rounding of a pooled value.  Gradients
    within 3e-2 of each one's largest magnitude: the backward rounds every
    cotangent to bf16 (2^-8 relative), and XLA sums a bf16 cotangent over
    the batch (the biases', LayerNorm's and the pooled blocks' gradients)
    with roundings of its own where torch accumulates in float32; over the
    12 x 200 entities of a block that leaves such a gradient about 1e-2 of
    its largest magnitude apart (up to 1.8e-2 seen, gelu's partner bias)."""
    variables = flax_variables(seed=1, act=act)
    obs = np.random.default_rng(4).standard_normal((12, 3368)).astype(
        np.float32)
    jobs = jnp.asarray(obs).astype(getattr(jnp, obs_dtype))
    tobs = torch.from_numpy(obs).to(getattr(torch, obs_dtype))
    flax_policy = FlaxPolicy(FlaxPolicyConfig(
        act_func=act, dtype=jnp.bfloat16, fused_embed=fused))

    def jloss(v):
        logits, value = flax_policy.apply(v, jobs)
        return (logits ** 2).sum() + (value ** 2).sum()

    jlogits, jvalue = flax_policy.apply(variables, jobs)
    jgrads = params_from_flax(jax.tree.map(
        np.asarray, jax.grad(jloss)(variables)))
    policy = LateFusionPolicy(PolicyConfig(act_func=act, fused_embed=fused,
                                           dtype=torch.bfloat16),
                              device="cpu")
    policy.load_state_dict(params_from_flax(variables))
    logits, value = policy(tobs)
    assert logits.dtype == value.dtype == torch.float32
    for got, want in ((logits, jlogits), (value, jvalue)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())
    ((logits ** 2).sum() + (value ** 2).sum()).backward()
    for name, p in policy.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        want = jgrads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (name, err)


def test_bf16_iteration_trains_close_to_f32():
    """One iteration from the same seed in both dtypes: every parameter
    within atol 2e-2, rtol 2e-1 of the float32 one, the losses finite and
    the entropies within 0.05 (a fresh policy's is near log 91 in both):
    the JAX package's own bar for its bf16 policy dtype."""
    env = slice_env(POOL_SCENES[:2], device="cpu")
    results = []
    for dtype in ("float32", "bfloat16"):
        ppo, carry, fresh, train_fn = build_trainer(
            env, PPOConfig(rollout_len=8, num_minibatches=2,
                           policy_dtype=dtype), seed=7)
        assert ppo.policy.config.dtype == getattr(torch, dtype)
        _, metrics = train_fn(env.scene, carry, fresh, env.reward_weights)
        results.append(([p.detach().clone() for p in ppo.policy.parameters()],
                         {k: float(v) for k, v in metrics.items()}))
    (pa, ma), (pb, mb) = results
    for a, b in zip(pa, pb):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2, rtol=2e-1)
    for k in ("pg_loss", "v_loss", "entropy"):
        assert np.isfinite(mb[k]), k
    assert abs(ma["entropy"] - mb["entropy"]) <= 0.05


def test_unfused_bf16_pool_splits_ties_exactly():
    """The unfused bf16 block's max splits the pooled cotangent evenly
    among tied maxima (as jnp.max does), and the sum over entities that
    gives the last Dense's bias gradient is taken in float32: it equals the
    sum of the pooled cotangent over the rows within bf16 rounding, 2^-8 of
    the sum of magnitudes.  Real observations: the padding rows of the
    partner and road blocks tie.  (The JAX package on the CPU sums that
    bf16 cotangent in bf16, 53% of the largest entry away from the exact
    sum on these inputs, so test_bf16_policy_matches_flax draws its
    observations without ties.)"""
    env = slice_env(POOL_SCENES[20:22], device="cpu", agent_bucket="auto")
    obs = env.get_obs().reshape(-1, 3368)
    policy = LateFusionPolicy(PolicyConfig(dtype=torch.bfloat16), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    co = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (obs.shape[0], 64)).astype(np.float32))
    co_bf16 = co.to(torch.bfloat16).double()
    blocks = ((policy.partner_embed, obs[:, 6:768].unflatten(-1, (127, 6))),
              (policy.road_map_embed, obs[:, 768:].unflatten(-1, (200, 13))))
    for embed, x in blocks:
        embed.zero_grad()
        pooled = policy._pool(embed, x)
        assert pooled.dtype == torch.bfloat16
        (pooled.float() * co).sum().backward()
        got = embed[4].bias.grad.double()
        want = co_bf16.sum(0)
        assert float((got - want).abs().max()) <= 2.0 ** -8 * float(
            co_bf16.abs().sum(0).max())
