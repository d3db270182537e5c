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
tensor (K3 or K4 in float32, K3-bf16 or K4-bf16 in compute dtype bfloat16;
counting launches in ``.launches``, those of the bf16 compute mode also in
``.bf16_launches``) and uses its plain version
(``reference_embed_pool_argmax``, ``reference_embed_pool_bwd``) only for CPU
tensors.  ``fused_embed_pool`` puts the pair behind a
``torch.autograd.Function``.

Compute dtypes.  ``compute_dtype=torch.float32`` (the default) computes in
float32.  ``torch.bfloat16`` is the JAX package's compute dtype bfloat16
(``meta = (act, "bfloat16")``, ``_embed_chunk`` :69-82 and the backward
:136-172): the operands of every product are rounded to bf16 with round to
nearest even (``round_bf16``) and the products are summed in float32;
biases, LayerNorm statistics, the activation, the max and the sums of db1,
dg, dbe and db2 stay float32.  x may then be stored in float32 or bfloat16;
the parameters are float32, as flax stores them.  The plain versions do the
same arithmetic on bf16-valued float32 operands (a product of two bf16
values is exact in float32), so the kernels differ from them only in the
order of the sums.

Source note, K3.  Replaces ``fused_embed_pool``'s forward: ``_fused_fwd_impl``
and ``_fwd_kernel`` (fused_embed.py:84-109, 198-228).  Bound on the H100:
operations, ~150 GFLOP for the policy's two blocks at 65,536 rows against
~0.9 GB of input.  The two products (``embed_mma_flops``) run on the tensor
cores as wgmma m64n64k8 TF32 in the 3xTF32 split (each operand as hi + lo,
three passes; one TF32 pass gives ~1e-3 errors and breaks the argmax), so
their bound is 3 x their operations at 495 TFLOP/s; the rest
(``embed_flops`` minus the products: biases, LayerNorm, tanh, the max)
stays on the fp32 cores.  Design: a block is one warpgroup, each warp
holding 16 entities of its row; layer 1, LayerNorm (quad shuffles), the
activation and layer 2 stay in registers (w2's rows are permuted so that
layer 1's accumulators are layer 2's A operand), w1 and w2 sit in shared
memory pre-split, x is read straight into the fragments at any alignment,
and persistent blocks walk the rows, one row per warp.  The argmax tie
rule is the smallest entity index (see the CUDA source); the same inputs
give the same bits on every launch.

Source note, K3-bf16 (``csrc/fused_embed_bf16.cu``, the bf16 compute mode).
Both products on native bf16 wgmma m64n64k16 with f32 accumulators (A from
registers, two bf16 to a register): layer 1 is one k16 step, and layer 1's
accumulators, rounded and packed in pairs, are layer 2's A fragments as
they stand.  Its bound is the bf16 products at 989 TFLOP/s beside the
f32 rest on the fp32 cores, about equal, but the epilogue's instructions
(exact tanhf alone is 16) set the pace on the card: three warpgroups an
SM (110-115 registers a thread) interleave one's LayerNorm and tanhf with
another's products, and x is staged in shared memory by cp.async, a ring
of 3 chunks of 64 entities per warp (bf16 rows of 12 or 26 bytes at any
2-byte alignment are copied as the enclosing 16-byte-aligned span).  Same
tie rule, same bits on every launch.

Source note, K4.  Replaces ``_bwd_kernel`` and ``_fused_bwd``
(fused_embed.py:112-172, 236-280).  The Pallas kernel adds every grid step
into one output block, which is safe only because the TPU grid runs in
order; K4 gives each block a fixed range of rows and its own partial sums,
then adds the partials in a fixed order in a second kernel, so the
gradients are deterministic.  Only the entities that win one of the 64
units receive a cotangent, so K4 recomputes those (at most 64 per row) and
not all E.  Bound on the H100: fp32 operations (``bwd_flops``), since x is
read only at the winners; the kernel is bound by latency above that, so it
works on tiles of 16 rows: their winners (``winner_table`` is the plain
version of that step) are found per row, gathered together and recomputed
by all warps at once, with three block barriers per tile.  The gradients
equal the Pallas kernel's except on exact ties of the pooled maximum
between different entities, which K3 gives to the smallest entity index
(jnp.max splits them); ties between identical entity rows, such as the
observation's padding rows, give the same gradients either way.

Source note, K4-bf16 (``csrc/fused_embed_bwd_bf16.cu``, the bf16 compute
mode).  The operands of every product rounded as the JAX kernel rounds
them (x, w1; dpool and w2 for dt; t and dpool for dw2; x and dpre for
dw1), and the products on the tensor cores: each chunk of a tile's
winners becomes dense matrices (Xw, their x; dY, dpool at the units each
won), a warp runs 16 winners through layer 1 and dT = dY w2^T on
mma.sync m16n8k16 bf16, the LayerNorm and activation backward in f32
registers, and after a barrier dw2 += t^T dY and dw1 += Xw^T dpre run with
the chunk's winners as the k dimension.  db1, dg, dbe and db2 stay f32
sums of unrounded values; the deterministic two-kernel sum is K4's.  Its
bound charges the products (``bwd_mma_flops``) at the bf16 tensor-core
rate; the bytes of argmax and dpool bind it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gpudrive_lab_torch import cuda_build

LN_EPS = 1e-6  # flax.linen.LayerNorm default
_ACTS = {"tanh": 0, "gelu": 1}
_DTYPES = (torch.float32, torch.bfloat16)


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """v rounded to the nearest bf16 (ties to even, as JAX's
    ``astype(bfloat16)``), as float32."""
    return v.to(torch.bfloat16).to(torch.float32)


def _operand(cd):
    """How a product's operand enters it in compute dtype ``cd``: as it is
    in float32, rounded to bf16 in bfloat16."""
    return round_bf16 if cd == torch.bfloat16 else (lambda v: v)


def embed_mma_flops(F_in: int, H: int = 64) -> int:
    """Operations per entity of the embed stack's two products,
    2*F*H + 2*H*H: the part K3 runs on the tensor cores (three times, in
    the 3xTF32 split)."""
    return 2 * F_in * H + 2 * H * H


def embed_flops(F_in: int, H: int = 64) -> int:
    """fp32 operations per entity of the embed stack: the two products
    (``embed_mma_flops``), the biases (2*H) and about 8*H for LayerNorm, the
    activation's affine and the running max (tanh counted as one)."""
    return embed_mma_flops(F_in, H) + 10 * H


def bwd_flops(F_in: int, rows: int, winners: int, H: int = 64) -> int:
    """fp32 operations of K4 over ``rows`` rows holding ``winners`` (row,
    winning entity) pairs in all: per winner layer 1 and dw1 (4*F*H) and
    about 20*H for LayerNorm, the activation and their backward; per row
    the cotangent of t (2*H*H) and dw2, db2 (2*H*H + H)."""
    return winners * (4 * F_in * H + 20 * H) + rows * (4 * H * H + H)


def bwd_mma_flops(F_in: int, rows: int, winners: int, H: int = 64) -> int:
    """The products among ``bwd_flops``: per winner layer 1 and dw1
    (4*F*H), per row the cotangent of t and dw2 (4*H*H).  In compute dtype
    bfloat16 they are bf16 x bf16 products; the rest of ``bwd_flops``
    (LayerNorm, the activation, the bias sums) is float32 work."""
    return winners * 4 * F_in * H + rows * 4 * H * H


def bf16_flip_bound(act: str, g, be, w2) -> float:
    """The most that one bf16 rounding flip of an activation output t
    moves an entity's output y in compute dtype bfloat16.  Two versions
    that sum the same products in another order round t to bf16 from float32
    values a few ulps apart, so now and then t lands on the other side of a
    rounding boundary: bf16(t) moves by one bf16 ulp, at most 2^-7 |t|, and
    y_j by that times |w2[k, j]|.  |t| <= 1 for tanh; for gelu |t| <= |lin|
    <= sqrt(H - 1) max|g| + max|be| (a LayerNorm output has |xh| <=
    sqrt(H - 1))."""
    H = w2.shape[0]
    t_max = 1.0 if act == "tanh" else float(
        (H - 1) ** 0.5 * g.abs().max() + be.abs().max())
    return 2.0 ** -7 * t_max * float(w2.abs().max())


def _act(x, act: str):
    return torch.tanh(x) if act == "tanh" else F.gelu(x, approximate="tanh")


def _embed(x, w1, b1, g, be, w2, b2, act: str, cd=torch.float32):
    """[..., F] -> [..., H]: Linear -> LayerNorm -> act -> Linear in the
    parameters' dtype (float32; float64 for a reference), with the JAX
    package's recipe (LN statistics as mean of squares of the
    centred values, eps 1e-6); in compute dtype bfloat16 the products'
    operands are rounded to bf16 first."""
    r = _operand(cd)
    pre = r(x.to(w1.dtype)) @ r(w1) + b1
    mu = pre.mean(dim=-1, keepdim=True)
    var = ((pre - mu) * (pre - mu)).mean(dim=-1, keepdim=True)
    xh = (pre - mu) * torch.rsqrt(var + LN_EPS)
    return r(_act(xh * g + be, act)) @ r(w2) + b2


def reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act="tanh",
                                compute_dtype=torch.float32):
    """Plain version of K3: (pooled [B, H] f32, argmax [B, H] int32).  The
    argmax among exactly equal maxima is whichever torch.max reports."""
    y = _embed(x, w1, b1, g, be, w2, b2, act, compute_dtype)
    pooled, arg = y.max(dim=-2)
    return pooled, arg.to(torch.int32)


def reference_embed_pool(x, w1, b1, g, be, w2, b2, act="tanh",
                         compute_dtype=torch.float32):
    """Plain version of K3's pooled output, max_e Embed(x)[.., e, :]."""
    return reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act,
                                       compute_dtype)[0]


def _act_grad(lin, t, act: str):
    """d act / d lin at lin, given t = act(lin); gelu' in the tanh form
    (fused_embed.py:151-161)."""
    if act == "tanh":
        return 1.0 - t * t
    c, a = 0.7978845608028654, 0.044715
    th = torch.tanh(c * (lin + a * lin * lin * lin))
    return (0.5 * (1.0 + th)
            + 0.5 * lin * (1.0 - th * th) * c * (1.0 + 3.0 * a * lin * lin))


def _bwd_parts(x, w1, b1, g, be, w2, b2, argmax, dpool, act, cd,
               unrounded=()):
    """The plain backward: (the operands of dw1's and dw2's products as
    they enter them, and the six gradients).  ``unrounded`` names operands
    ("t", "dpre") that compute dtype bfloat16 leaves unrounded."""
    E = x.shape[-2]
    r = _operand(cd)
    keep = {n: (lambda v: v) if n in unrounded else r for n in ("t", "dpre")}
    x = r(x.float())
    pre = x @ r(w1) + b1
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
    t_op, dy_op = keep["t"](t), r(dy)
    dw2 = torch.einsum("bek,bej->kj", t_op, dy_op)
    dlin = (dy_op @ r(w2).t()) * _act_grad(lin, t, act)
    dxh = dlin * g
    dpre = (dxh - dxh.mean(dim=-1, keepdim=True)
            - xh * (dxh * xh).mean(dim=-1, keepdim=True)) * rstd
    dpre_op = keep["dpre"](dpre)
    grads = (torch.einsum("bef,bek->fk", x, dpre_op), dpre.sum((0, 1)),
             (dlin * xh).sum((0, 1)), dlin.sum((0, 1)), dw2, dy.sum((0, 1)))
    return (x, dpre_op, t_op, dy_op), grads


def reference_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax, dpool,
                             act="tanh", compute_dtype=torch.float32,
                             unrounded=()):
    """Plain version of K4: the gradients (dw1 [F, H], db1, dg, dbe [H],
    dw2 [H, H], db2 [H]) of sum(pooled * dpool), with the pooled cotangent
    sent to the winner ``argmax`` [B, H] (entries outside [0, E) send
    nothing).  Recomputes every entity's activations.  In compute dtype
    bfloat16 every product's operands are rounded to bf16 (x, w1; t and the
    cotangent for dw2; the cotangent and w2 for dt; x and dpre for dw1),
    and db1, dg, dbe, db2 sum the unrounded values.  ``unrounded``
    ("t", "dpre") leaves those operands of dw2 and dw1 unrounded: a
    deliberately wrong variant, the control that shows a bar of
    ``BF16_PRODUCT_BAR`` rejects a version missing that rounding."""
    return _bwd_parts(x, w1, b1, g, be, w2, b2, argmax, dpool, act,
                      compute_dtype, unrounded)[1]


# How far dw1 and dw2 of two sound versions of K4's bf16 mode may differ,
# as a share of their terms' root-sum-square (``bwd_product_rss``).  Both
# sum products of operands rounded to bf16 (x and dpre; t and the
# cotangent), computed in float32 in another order, so an operand's float32
# values differ by a few ulps between them.  Only where a bf16 rounding
# boundary falls between the two does the rounded operand differ, by one
# bf16 ulp, at most 2^-7 of the term.  With the float32 values within 64
# ulps (2^-18 relative) that befalls at most 2^-18 / 2^-8 = 2^-10 of the
# terms, so the moves' root-sum-square is at most sqrt(2^-10) * 2^-7 =
# 2^-12 of all the terms'.  A version that skips one of the roundings moves
# every term by its rounding error, uniform within half a bf16 ulp: about
# 2^-8.5 / sqrt(3) = 1.6e-3 of the root-sum-square, 6.7 times the bar.
BF16_PRODUCT_BAR = 2.0 ** -12


def bwd_product_rss(x, w1, b1, g, be, w2, b2, argmax, dpool, act="tanh",
                    compute_dtype=torch.float32):
    """(dw1's, dw2's) root-sum-square of the plain backward's product
    terms, sqrt(sum over each entry's terms of (a * b)^2): the scale of
    their rounding errors, for ``bf16_product_error``."""
    (x, dpre, t, dy), _ = _bwd_parts(x, w1, b1, g, be, w2, b2, argmax,
                                     dpool, act, compute_dtype)
    return (torch.einsum("bef,bek->fk", x * x, dpre * dpre).sqrt(),
            torch.einsum("bek,bej->kj", t * t, dy * dy).sqrt())


def bf16_product_error(got, want, rss) -> float:
    """||got - want|| / ||rss|| (Frobenius norms): a dw1 or dw2 error as a
    share of its terms' root-sum-square, held at ``BF16_PRODUCT_BAR``."""
    return float((got.float() - want.float()).norm()
                 / rss.float().norm().clamp_min(1e-30))


def winner_table(argmax, E: int):
    """Plain version of K4's first step: each row's distinct winning
    entities, in order of their first unit.  argmax [B, H] (entries outside
    [0, E) have no winner).  Returns (count [B] int64: distinct winners per
    row; rank [B, H] int64: the position of unit j's winner in its row's
    order, -1 where the unit has none).  Runs on the argmax's device without
    a host sync."""
    ok = (argmax >= 0) & (argmax < E)
    a = torch.where(ok, argmax, -1).long()
    same = a[:, :, None] == a[:, None, :]  # [B, j, u]: units j, u share e
    lead = same.to(torch.uint8).argmax(-1)  # first unit with j's winner
    first = ok & (lead == torch.arange(a.shape[1], device=a.device))
    order = torch.cumsum(first, dim=1) - 1
    rank = torch.where(ok, torch.gather(order, 1, lead), -1)
    return first.sum(dim=1), rank


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point of K3 and K4 (all return an int status)
_SIGNATURES = {
    "fused_embed_pool_fwd": [_P] * 9 + [_I, _I, _I, _LL, _I, _P],
    "fused_embed_pool_fwd_bf16": [_P] * 9 + [_I, _I, _I, _LL, _I, _I, _P],
    "fused_embed_pool_bwd": [_P] * 10 + [_I, _I, _I, _LL, _I, _I, _P],
    "fused_embed_pool_bwd_bf16": [_P] * 10 + [_I, _I, _I, _LL, _I, _I, _I,
                                              _P],
    "fused_embed_pool_bwd_blocks": [_I],
    "fused_embed_pool_bwd_blocks_bf16": [_I, _I],
}
_ENTRIES = {
    "fused_embed": ("fused_embed_pool_fwd",),
    "fused_embed_bf16": ("fused_embed_pool_fwd_bf16",),
    "fused_embed_bwd": ("fused_embed_pool_bwd",
                        "fused_embed_pool_bwd_blocks"),
    "fused_embed_bwd_bf16": ("fused_embed_pool_bwd_bf16",
                             "fused_embed_pool_bwd_blocks_bf16"),
}


def declare(lib, names) -> None:
    """Declare the ctypes signatures of the entry points ``names`` of a
    loaded K3 or K4 library."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name], _I
    lib._argtypes_set = True


def _lib(name: str):
    lib = cuda_build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        declare(lib, _ENTRIES[name])
    return lib


def _check_inputs(x, params: dict, act: str, cd):
    """Shared checks of K3 and K4: act, the compute dtype, dtypes (x in
    float32, or bfloat16 in compute dtype bfloat16; parameters float32),
    the parameter shapes and x's layout.  Returns (B, E, F) and the set of
    devices."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if cd not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cd}")
    if x.dim() != 3:
        raise ValueError(f"x: expected [B, E, F], got {tuple(x.shape)}")
    B, E, Fi = x.shape
    H = 64
    shapes = {"w1": (Fi, H), "b1": (H,), "g": (H,), "be": (H,),
              "w2": (H, H), "b2": (H,)}
    for name, t in {"x": x, **params}.items():
        ok = (torch.float32, cd) if name == "x" else (torch.float32,)
        if t.dtype not in ok:
            raise TypeError(f"{name}: expected {' or '.join(map(str, ok))} "
                            f"in compute dtype {cd}, got {t.dtype}")
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


def fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act="tanh",
                         compute_dtype=torch.float32):
    """K3.  x [B, E, F] float32 (F <= 16, E >= 1) whose rows are each
    contiguous (a [B, E, F] view of a slice of the flat observation is
    taken in place), or bfloat16 in compute dtype bfloat16; w1 [F, 64];
    b1, g, be, b2 [64]; w2 [64, 64], float32 and contiguous, as flax stores
    them.  ``compute_dtype`` is torch.float32 or torch.bfloat16 (module
    docstring).  Returns (pooled [B, 64] float32, argmax [B, 64] int32)."""
    cd = compute_dtype
    (B, E, Fi), devs = _check_inputs(
        x, dict(w1=w1, b1=b1, g=g, be=be, w2=w2, b2=b2), act, cd)
    H = 64
    if devs == {torch.device("cpu")}:
        return reference_embed_pool_argmax(x, w1, b1, g, be, w2, b2, act, cd)
    _cuda_device(devs, x)
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    amax = torch.empty((B, H), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, amax
    lib = _lib("fused_embed" if cd == torch.float32 else "fused_embed_bf16")
    args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
            be.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            amax.data_ptr(), B, E, Fi, x.stride(0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if cd == torch.float32:
        status = lib.fused_embed_pool_fwd(*args, _ACTS[act], stream)
    else:
        status = lib.fused_embed_pool_fwd_bf16(
            *args, int(x.dtype == torch.bfloat16), _ACTS[act], stream)
    cuda_build.check(status, "fused_embed_pool_fwd")
    fused_embed_pool_fwd.launches += 1
    fused_embed_pool_fwd.bf16_launches += cd == torch.bfloat16
    return out, amax


fused_embed_pool_fwd.launches = 0
fused_embed_pool_fwd.bf16_launches = 0


def fused_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax, dpool,
                         act="tanh", compute_dtype=torch.float32):
    """K4.  x, the parameters and ``compute_dtype`` as for K3; argmax
    [B, 64] int32 from K3 and the pooled cotangent dpool [B, 64] float32.
    Returns the gradients (dw1 [F, 64], db1, dg, dbe [64], dw2 [64, 64],
    db2 [64]) of sum(pooled * dpool), float32; d/dx is not computed.
    Deterministic: the same inputs give the same bits on every run."""
    cd = compute_dtype
    (B, E, Fi), devs = _check_inputs(
        x, dict(w1=w1, b1=b1, g=g, be=be, w2=w2, b2=b2), act, cd)
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
                                        dpool, act, cd)
    _cuda_device(devs, x)
    n_out = Fi * H + H * H + 4 * H
    out = torch.zeros((n_out,), dtype=torch.float32, device=x.device)
    if B > 0:
        lib = _lib("fused_embed_bwd" if cd == torch.float32
                   else "fused_embed_bwd_bf16")
        x_bf16 = int(x.dtype == torch.bfloat16)
        # as many blocks as run at once; each writes one partial row
        nblocks = (lib.fused_embed_pool_bwd_blocks(B) if cd == torch.float32
                   else lib.fused_embed_pool_bwd_blocks_bf16(B, x_bf16))
        if nblocks < 1:
            raise RuntimeError("fused_embed_pool_bwd: no launch configuration")
        partial = torch.empty((nblocks, n_out), dtype=torch.float32,
                              device=x.device)
        argmax, dpool = argmax.contiguous(), dpool.contiguous()
        args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(),
                be.data_ptr(), w2.data_ptr(), argmax.data_ptr(),
                dpool.data_ptr(), partial.data_ptr(), out.data_ptr(), B, E,
                Fi, x.stride(0), nblocks)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if cd == torch.float32:
            status = lib.fused_embed_pool_bwd(*args, _ACTS[act], stream)
        else:
            status = lib.fused_embed_pool_bwd_bf16(*args, x_bf16, _ACTS[act],
                                                   stream)
        cuda_build.check(status, "fused_embed_pool_bwd")
        fused_embed_pool_bwd.launches += 1
        fused_embed_pool_bwd.bf16_launches += cd == torch.bfloat16
    dw1, db1, dg, dbe, dw2, db2 = torch.split(
        out, [Fi * H, H, H, H, H * H, H])
    return (dw1.view(Fi, H), db1, dg, dbe, dw2.view(H, H), db2)


fused_embed_pool_bwd.launches = 0
fused_embed_pool_bwd.bf16_launches = 0


class _FusedEmbedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g, be, w2, b2, act, cd):
        pooled, argmax = fused_embed_pool_fwd(x, w1, b1, g, be, w2, b2, act,
                                              cd)
        ctx.save_for_backward(x, w1, b1, g, be, w2, b2, argmax)
        ctx.act, ctx.cd = act, cd
        return pooled

    @staticmethod
    def backward(ctx, dpool):
        x, w1, b1, g, be, w2, b2, argmax = ctx.saved_tensors
        grads = fused_embed_pool_bwd(x, w1, b1, g, be, w2, b2, argmax,
                                     dpool, ctx.act, ctx.cd)
        return (None, *grads, None, None)


def fused_embed_pool(x, w1, b1, g, be, w2, b2, act="tanh",
                     compute_dtype=torch.float32):
    """max_e Embed(x)[.., e, :] through K3, differentiable in the
    parameters through K4 (d/dx is None: never use it where x needs a
    gradient).  x [B, E, F]; parameters as flax stores them (w1 [F, H],
    w2 [H, H]); ``compute_dtype`` torch.float32 or torch.bfloat16.  Returns
    pooled [B, H] float32."""
    return _FusedEmbedPool.apply(x, w1, b1, g, be, w2, b2, act,
                                 compute_dtype)
