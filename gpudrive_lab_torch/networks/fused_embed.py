"""Fused embed + max-pool forward for the late-fusion policy: kernel K3.

Port of ``gpudrive_lab_tpu/networks/fused_embed.py`` (forward only).  Per
entity: Linear(F->64) -> LayerNorm (f32 statistics, eps 1e-6) -> tanh or
gelu (tanh form) -> Linear(64->64); then the max over entities and its
argmax.  The kernel (``csrc/fused_embed.cu``) keeps the [B, E, 64]
activations on chip and writes only the pooled [B, 64] row and the winning
entity index [B, 64].

``fused_embed_pool_fwd`` is the wrapper: it checks its inputs, allocates the
outputs, launches the kernel on a CUDA tensor (counting launches in
``fused_embed_pool_fwd.launches``) and uses the plain version
``reference_embed_pool_argmax`` only for CPU tensors.  ``fused_embed_pool``
puts it behind a ``torch.autograd.Function`` whose backward (kernel K4, the
parameter gradients of the PPO update) is not ported yet and raises.

Source note.  Replaces ``fused_embed_pool``'s forward: ``_fused_fwd_impl``
and ``_fwd_kernel`` (fused_embed.py:84-109, 198-228).  Bound on the H100 at
the slice's road block (B = 65,536 rows, E = 200, F = 13): ~130 GFLOP of
fp32 work (EMBED_FLOPS per entity) against 681 MB of input, so operations
bound it (the kernel runs on the fp32 cores, not the tensor cores).
Design: one warp per row, two hidden units per lane; the entity group's
inputs are staged in shared memory with one coalesced load, layer 1 runs
from registers, LayerNorm statistics are warp-shuffle sums, and layer 2
reads w2 from shared memory once per group of 4 entities, so shared-memory
loads stay below the FMA count.  The argmax tie rule is the smallest
entity index (see the CUDA source).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gpudrive_lab_torch import cuda_build

LN_EPS = 1e-6  # flax.linen.LayerNorm default
_ACTS = {"tanh": 0, "gelu": 1}


def embed_flops(F_in: int, H: int = 64) -> int:
    """fp32 operations per entity of the embed stack: the two matmuls
    (2*F*H + 2*H*H), the biases (2*H) and about 8*H for LayerNorm, the
    activation's affine and the running max (tanh counted as one)."""
    return 2 * F_in * H + 2 * H * H + 10 * H


def _act(x, act: str):
    return torch.tanh(x) if act == "tanh" else F.gelu(x, approximate="tanh")


def _embed(x, w1, b1, g, be, w2, b2, act: str):
    """[..., F] -> [..., H]: Linear -> LayerNorm -> act -> Linear in f32,
    with the JAX package's recipe (LN statistics as mean of squares of the
    centred values, eps 1e-6)."""
    pre = x @ w1 + b1
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    xh = (pre - mu) * torch.rsqrt(var + LN_EPS)
    return _act(xh * g + be, act) @ w2 + b2


def reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act="tanh"):
    """Plain version of K3: (pooled [B, H] f32, argmax [B, H] int32).  The
    argmax among exactly equal maxima is whichever torch.max reports."""
    y = _embed(x, w1, b1, g, be, w2, b2, act)
    pooled, arg = y.max(dim=-2)
    return pooled, arg.to(torch.int32)


def reference_embed_pool(x, w1, b1, g, be, w2, b2, act="tanh"):
    """Plain version of K3's pooled output, max_e Embed(x)[.., e, :]."""
    return reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act)[0]


def _lib():
    lib = cuda_build.load("fused_embed")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_embed_pool_fwd.argtypes = (
            [p] * 9 + [i, i, i, ctypes.c_longlong, i, p]
        )
        lib.fused_embed_pool_fwd.restype = i
        lib._argtypes_set = True
    return lib


def fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act="tanh"):
    """K3.  x [B, E, F] float32 (F <= 16, E >= 1) whose rows are each
    contiguous (a [B, E, F] view of a slice of the flat observation is
    taken in place); w1 [F, 64]; b1, g, be, b2 [64]; w2 [64, 64], float32
    and contiguous, as flax stores them.  Returns (pooled [B, 64] float32,
    argmax [B, 64] int32)."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if x.dim() != 3:
        raise ValueError(f"x: expected [B, E, F], got {tuple(x.shape)}")
    B, E, Fi = x.shape
    H = 64
    shapes = {"w1": (Fi, H), "b1": (H,), "g": (H,), "be": (H,),
              "w2": (H, H), "b2": (H,)}
    tensors = {"x": x, "w1": w1, "b1": b1, "g": g, "be": be, "w2": w2,
               "b2": b2}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{name}: expected {shapes[name]}, got {tuple(t.shape)}"
            )
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if (x.stride(2) != 1 or x.stride(1) != Fi) and B * E * Fi:
        raise ValueError(
            f"x: each row's [E, F] block must be contiguous, strides "
            f"{x.stride()}"
        )
    if E < 1 or not 1 <= Fi <= 16:
        raise ValueError(f"x: need E >= 1 and 1 <= F <= 16, got {E}, {Fi}")
    devs = {t.device for t in tensors.values()}
    if devs == {torch.device("cpu")}:
        return reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"inputs on {devs}: must share one CUDA device")
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    amax = torch.empty((B, H), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, amax
    status = _lib().fused_embed_pool_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
        be.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        amax.data_ptr(), B, E, Fi, x.stride(0), _ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(status, "fused_embed_pool_fwd")
    fused_embed_pool_fwd.launches += 1
    return out, amax


fused_embed_pool_fwd.launches = 0


class _FusedEmbedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g, be, w2, b2, act):
        return fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act)[0]

    @staticmethod
    def backward(ctx, dpool):
        raise NotImplementedError("K4: training slice")


def fused_embed_pool(x, w1, b1, g, be, w2, b2, act="tanh"):
    """max_e Embed(x)[.., e, :] through K3, as a differentiable op whose
    backward (K4) is not ported yet.  x [B, E, F]; parameters as flax
    stores them (w1 [F, H], w2 [H, H]).  Returns pooled [B, H] float32."""
    return _FusedEmbedPool.apply(x, w1, b1, g, be, w2, b2, act)
