"""flax's compute-dtype semantics in PyTorch: what a flax 0.12.3 layer built
with ``dtype=`` computes, for the port's networks that take a compute dtype
(``networks/late_fusion.py``, ``vbd/model.py``).

Parameters stay float32; ``cd`` is the compute dtype.  With ``cd``
float32 each function is the torch module's own call (the float32 path
keeps its ops and bits); with torch.bfloat16 or torch.float16:

  * ``dense``: flax ``Dense(dtype=cd)``: the input, kernel and bias cast
    to cd, the product in cd, then the bias added in cd (two roundings).
  * ``layer_norm``: flax ``LayerNorm(dtype=cd)``: float32 statistics with
    the fast variance (E[x^2] - E[x]^2), (x - mean) * (rsqrt(var + eps) *
    scale) + bias in float32, then cast to cd.
  * ``gelu``: ``jax.nn.gelu``'s tanh form op by op in cd, its constants
    rounded to cd (torch's gelu computes in float32 with the exact
    constants).
  * ``sigmoid``: ``jax.nn.sigmoid`` as XLA expands it, 1 / (1 + exp(-x))
    op by op in cd (torch's sigmoid rounds once from float32; the two
    differ by a cd ulp in about a third of the values).
  * ``softmax``: ``jax.nn.softmax`` op by op in cd: exp(x - max) rounded
    to cd, the sum accumulated in float32 and rounded to cd (jnp.sum
    upcasts half-precision sums), then the quotient in cd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

#: The compute dtypes a flax module's ``dtype`` may take in the port.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def cd_value(v: float, cd: torch.dtype) -> float:
    """The Python float ``v`` as compute dtype ``cd`` holds it."""
    return torch.tensor(v, dtype=cd).item()


# jax.nn.gelu's constants, sqrt(2 / pi) and 0.044715, as each half
# precision holds them
_GELU = {cd: (cd_value((2.0 / torch.pi) ** 0.5, cd), cd_value(0.044715, cd))
         for cd in COMPUTE_DTYPES[1:]}


def dense(lin: nn.Linear, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    if cd == torch.float32:
        return lin(x)
    return torch.matmul(x.to(cd), lin.weight.t().to(cd)) + lin.bias.to(cd)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               cd: torch.dtype) -> torch.Tensor:
    if cd == torch.float32:
        return ln(x)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight
    return ((xf - mu) * mul + ln.bias).to(cd)


def gelu(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    if cd == torch.float32:
        return F.gelu(x, approximate="tanh")
    c, a = _GELU[cd]
    u = c * (x + a * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(u)))


def sigmoid(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    if cd == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Softmax over the last axis."""
    if cd == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)
