"""Fused embed + max-pool for the late-fusion policy: kernels K3 and K4.

Port of ``gpudrive_lab_tpu/networks/fused_embed.py``.  Per entity:
Linear(F->64) -> LayerNorm (f32 statistics, eps 1e-6) -> tanh or gelu (tanh
form) -> Linear(64->64); then the max over entities and its argmax.  The
forward kernel K3 (``csrc/fused_embed.cu``) keeps the [B, E, 64] activations
on chip and writes only the pooled [B, 64] row and the winning entity index
[B, 64].  The backward kernel K4 (``csrc/fused_embed_bwd.cu``) recomputes the
activations of the winning entities only and returns the six parameter
gradients; d/dx is not computed (the observation is data).

``fused_embed_pool_fwd`` and ``fused_embed_pool_bwd`` are the wrappers: each
checks its inputs, allocates the outputs, launches its kernel on a CUDA
tensor (counting launches in ``.launches``) and uses its plain version
(``reference_embed_pool_argmax``, ``reference_embed_pool_bwd``) only for CPU
tensors.  ``fused_embed_pool`` puts the pair behind a
``torch.autograd.Function``.

Source note, K3.  Replaces ``fused_embed_pool``'s forward: ``_fused_fwd_impl``
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

Source note, K4.  Replaces ``_bwd_kernel`` and ``_fused_bwd``
(fused_embed.py:112-172, 236-280).  The Pallas kernel adds every grid step
into one output block, which is safe only because the TPU grid runs in
order; K4 gives each block a fixed range of rows and its own partial sums,
then adds the partials in block order in a second kernel, so the gradients
are deterministic.  Only the entities that win one of the 64 units receive
a cotangent, so K4 recomputes those (at most 64 per row) and not all E.
Bound on the H100: fp32 operations (``bwd_flops``), since x is read only at
the winners.  The gradients equal the Pallas kernel's except on exact ties
of the pooled maximum between different entities, which K3 gives to the
smallest entity index (jnp.max splits them); ties between identical entity
rows, such as the observation's padding rows, give the same gradients
either way.
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


def bwd_flops(F_in: int, rows: int, winners: int, H: int = 64) -> int:
    """fp32 operations of K4 over ``rows`` rows holding ``winners`` (row,
    winning entity) pairs in all: per winner layer 1 and dw1 (4*F*H) and
    about 20*H for LayerNorm, the activation and their backward; per row
    the cotangent of t (2*H*H) and dw2, db2 (2*H*H + H)."""
    return winners * (4 * F_in * H + 20 * H) + rows * (4 * H * H + H)


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


def _act_grad(lin, t, act: str):
    """d act / d lin at lin, given t = act(lin); gelu' in the tanh form
    (fused_embed.py:151-161)."""
    if act == "tanh":
        return 1.0 - t * t
    c, a = 0.7978845608028654, 0.044715
    th = torch.tanh(c * (lin + a * lin * lin * lin))
    return (0.5 * (1.0 + th)
            + 0.5 * lin * (1.0 - th * th) * c * (1.0 + 3.0 * a * lin * lin))


def reference_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax, dpool,
                             act="tanh"):
    """Plain version of K4: the gradients (dw1 [F, H], db1, dg, dbe [H],
    dw2 [H, H], db2 [H]) of sum(pooled * dpool), with the pooled cotangent
    sent to the winner ``argmax`` [B, H] (entries outside [0, E) send
    nothing).  Recomputes every entity's activations."""
    E = x.shape[-2]
    pre = x @ w1 + b1
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xh = (pre - mu) * rstd
    lin = xh * g + be
    t = _act(lin, act)
    ok = (argmax >= 0) & (argmax < E)
    dy = torch.zeros_like(t)  # [B, E, H] cotangent of the entity outputs
    dy.scatter_(-2, torch.where(ok, argmax, 0).long().unsqueeze(-2),
                torch.where(ok, dpool, 0.0).unsqueeze(-2))
    dw2 = torch.einsum("bek,bej->kj", t, dy)
    dlin = (dy @ w2.t()) * _act_grad(lin, t, act)
    dxh = dlin * g
    dpre = (dxh - dxh.mean(dim=-1, keepdim=True)
            - xh * (dxh * xh).mean(dim=-1, keepdim=True)) * rstd
    return (torch.einsum("bef,bek->fk", x, dpre), dpre.sum((0, 1)),
            (dlin * xh).sum((0, 1)), dlin.sum((0, 1)), dw2, dy.sum((0, 1)))


def _lib(name: str):
    lib = cuda_build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "fused_embed":
            lib.fused_embed_pool_fwd.argtypes = [p] * 9 + [i, i, i, ll, i, p]
            lib.fused_embed_pool_fwd.restype = i
        else:
            lib.fused_embed_pool_bwd.argtypes = [p] * 10 + [i, i, i, ll, i,
                                                            i, p]
            lib.fused_embed_pool_bwd.restype = i
            lib.fused_embed_pool_bwd_blocks.argtypes = [i, i]
            lib.fused_embed_pool_bwd_blocks.restype = i
        lib._argtypes_set = True
    return lib


def _check_inputs(x, params: dict, act: str):
    """Shared checks of K3 and K4: act, dtypes, the parameter shapes and
    x's layout.  Returns (B, E, F) and the set of devices."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if x.dim() != 3:
        raise ValueError(f"x: expected [B, E, F], got {tuple(x.shape)}")
    B, E, Fi = x.shape
    H = 64
    shapes = {"w1": (Fi, H), "b1": (H,), "g": (H,), "be": (H,),
              "w2": (H, H), "b2": (H,)}
    for name, t in {"x": x, **params}.items():
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
    return (B, E, Fi), {t.device for t in (x, *params.values())}


def _cuda_device(devs, x):
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"inputs on {devs}: must share one CUDA device")


def fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act="tanh"):
    """K3.  x [B, E, F] float32 (F <= 16, E >= 1) whose rows are each
    contiguous (a [B, E, F] view of a slice of the flat observation is
    taken in place); w1 [F, 64]; b1, g, be, b2 [64]; w2 [64, 64], float32
    and contiguous, as flax stores them.  Returns (pooled [B, 64] float32,
    argmax [B, 64] int32)."""
    (B, E, Fi), devs = _check_inputs(
        x, dict(w1=w1, b1=b1, g=g, be=be, w2=w2, b2=b2), act)
    H = 64
    if devs == {torch.device("cpu")}:
        return reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act)
    _cuda_device(devs, x)
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    amax = torch.empty((B, H), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, amax
    status = _lib("fused_embed").fused_embed_pool_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
        be.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        amax.data_ptr(), B, E, Fi, x.stride(0), _ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(status, "fused_embed_pool_fwd")
    fused_embed_pool_fwd.launches += 1
    return out, amax


fused_embed_pool_fwd.launches = 0

# Most blocks K4 spreads the rows over (4 per SM of an H100); each writes
# one partial row of the gradients.
BWD_MAX_BLOCKS = 528


def fused_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax, dpool,
                         act="tanh"):
    """K4.  x and the parameters as for K3; argmax [B, 64] int32 from K3
    and the pooled cotangent dpool [B, 64] float32.  Returns the gradients
    (dw1 [F, 64], db1, dg, dbe [64], dw2 [64, 64], db2 [64]) of
    sum(pooled * dpool); d/dx is not computed.  Deterministic: the same
    inputs give the same bits on every run."""
    (B, E, Fi), devs = _check_inputs(
        x, dict(w1=w1, b1=b1, g=g, be=be, w2=w2, b2=b2), act)
    H = 64
    if tuple(argmax.shape) != (B, H) or argmax.dtype != torch.int32:
        raise ValueError(f"argmax: expected int32 {(B, H)}, got "
                         f"{argmax.dtype} {tuple(argmax.shape)}")
    if tuple(dpool.shape) != (B, H):
        raise ValueError(f"dpool: expected {(B, H)}, got "
                         f"{tuple(dpool.shape)}")
    dpool = dpool.to(torch.float32)
    devs = devs | {argmax.device, dpool.device}
    if devs == {torch.device("cpu")}:
        return reference_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax,
                                        dpool, act)
    _cuda_device(devs, x)
    n_out = Fi * H + H * H + 4 * H
    out = torch.zeros((n_out,), dtype=torch.float32, device=x.device)
    if B > 0:
        lib = _lib("fused_embed_bwd")
        nblocks = lib.fused_embed_pool_bwd_blocks(B, BWD_MAX_BLOCKS)
        partial = torch.empty((nblocks, n_out), dtype=torch.float32,
                              device=x.device)
        argmax, dpool = argmax.contiguous(), dpool.contiguous()
        status = lib.fused_embed_pool_bwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
            be.data_ptr(), w2.data_ptr(), argmax.data_ptr(),
            dpool.data_ptr(), partial.data_ptr(), out.data_ptr(), B, E, Fi,
            x.stride(0), nblocks, _ACTS[act],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        cuda_build.check(status, "fused_embed_pool_bwd")
        fused_embed_pool_bwd.launches += 1
    dw1, db1, dg, dbe, dw2, db2 = torch.split(
        out, [Fi * H, H, H, H, H * H, H])
    return (dw1.view(Fi, H), db1, dg, dbe, dw2.view(H, H), db2)


fused_embed_pool_bwd.launches = 0


class _FusedEmbedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g, be, w2, b2, act):
        pooled, argmax = fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act)
        ctx.save_for_backward(x, w1, b1, g, be, w2, b2, argmax)
        ctx.act = act
        return pooled

    @staticmethod
    def backward(ctx, dpool):
        x, w1, b1, g, be, w2, b2, argmax = ctx.saved_tensors
        grads = fused_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax,
                                     dpool, ctx.act)
        return (None, *grads, None)


def fused_embed_pool(x, w1, b1, g, be, w2, b2, act="tanh"):
    """max_e Embed(x)[.., e, :] through K3, differentiable in the
    parameters through K4 (d/dx is None: never use it where x needs a
    gradient).  x [B, E, F]; parameters as flax stores them (w1 [F, H],
    w2 [H, H]).  Returns pooled [B, H] float32."""
    return _FusedEmbedPool.apply(x, w1, b1, g, be, w2, b2, act)
