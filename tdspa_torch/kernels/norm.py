"""Row norms of the transformer stacks: CUDA kernel wrappers + their plain version.

The bias-free, centered LayerNorm (flax ``LayerNorm(use_bias=False)``) and
the per-head ``RMSNorm`` of ``core/attention.py::_Norm``, over the last axis,
in f32 statistics with eps 1e-6 and flax's fast variance. No TPU kernel
computes them: XLA fuses flax's norms into their neighbours, where eager
PyTorch runs each as about ten passes over the tensor.
``tdspa_torch/csrc/norm.cu`` reads a row once into registers and writes it
once (forward), and reads x and dy once and writes dx once (backward), for
f32 or bf16 x and an f32 or bf16 output.

``row_norm`` launches the kernel for CUDA tensors and runs
``row_norm_reference`` (today's eager chain, bit for bit) for CPU tensors,
through the custom op ``tdspa::row_norm`` (``kernels/ops.py``), which
``torch.export`` keeps in an exported tail; it never falls back from one to
the other. Where autograd records on CUDA tensors it goes through
``row_norm_fn``, whose backward is the backward kernel (``launch_backward``);
on CPU tensors autograd records through the eager chain itself, so CPU
gradients stay what they were. ``row_norm.launches`` and
``row_norm_backward.launches`` count kernel launches.

``row_norm_shared`` is the norm that several projections read while autograd
records (a block's query norm: query, key, value and the cross-attention's
query): one launch writes the compute dtype, and each reader gets its own
tensor over that output, so that its cotangent reaches the backward apart.
The backward kernel then sums the readers' cotangents in f32 registers.
``row_norm_shared.launches`` counts its forward launches and
``row_norm_shared.cotangents`` the cotangents its backward launches summed.
"""

from __future__ import annotations

import functools

import torch

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import aligned, on_cuda, records, rows

EPS = 1e-6  # flax LayerNorm / RMSNorm default
WARPS = 8  # warps a block of csrc/norm.cu
MAX_VALUES = 1536  # of a row that one warp's registers hold
# The backward's blocks an SM: whole waves whether 1, 2, 3, 4 or 6 of its
# blocks are resident at once (its registers allow 1 to 3 on an H100).
BACKWARD_BLOCKS_PER_SM = 12
MAX_COTANGENTS = 4  # the backward kernel's dy operands, summed in f32


def row_norm_reference(x, scale, centered: bool, out_dtype, bias=None, eps=EPS):
    """Plain PyTorch version: x [..., W] normed over W, times scale [W], plus
    bias [W] where given (flax's ``LayerNorm`` with its bias).

    ``mean2 = mean(x^2)``; centered: ``var = max(mean2 - mean(x)^2, 0)``,
    ``y = x - mean(x)``; RMS: ``var = mean2``, ``y = x``; then
    ``y * (rsqrt(var + eps) * scale) (+ bias)`` rounded once to ``out_dtype``.
    The arithmetic is f32 for f32 or bf16 x (f64 for f64 x).
    """
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    if centered:  # flax's fast variance: E[x^2] - E[x]^2
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = x32 - mean
    else:
        var, y = mean2, x32
    out = y * (torch.rsqrt(var + eps) * scale)
    return (out if bias is None else out + bias).to(out_dtype)


def row_norm_backward_reference(x, scale, dy, centered: bool):
    """Plain PyTorch version of the backward kernel: (dx in x's dtype, dscale
    in scale's dtype) for the cotangent dy of ``row_norm_reference``'s output.

    With r = rsqrt(var + eps) and g = dy * scale: centered
    ``dx = r (g - mean(g) - y r^2 mean(g y))``, the last term dropped in rows
    where the clamp held var at 0 (as autograd of ``clamp`` does); RMS
    ``dx = r (g - x r^2 mean(g x))``; ``dscale`` the sum over rows of
    ``dy y r``.
    """
    compute = torch.promote_types(x.dtype, torch.float32)
    x32, dy32 = x.to(compute), dy.to(compute)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    if centered:
        mean = x32.mean(-1, keepdim=True)
        d = mean2 - mean * mean
        var, y = torch.clamp(d, min=0.0), x32 - mean
    else:
        var, y = mean2, x32
    r = torch.rsqrt(var + EPS)
    g = dy32 * scale.to(compute)
    term = y * (r * r) * (g * y).mean(-1, keepdim=True)
    if centered:
        inner = g - g.mean(-1, keepdim=True) - torch.where(d >= 0, term, 0.0)
    else:
        inner = g - term
    dscale = (dy32 * y * r).reshape(-1, x.shape[-1]).sum(0)
    return (r * inner).to(x.dtype), dscale.to(scale.dtype)


@functools.cache
def plan(width: int, itemsize: int) -> dict:
    """How ``csrc/norm.cu`` holds a row of ``width`` values of ``itemsize``
    bytes: ``vec`` values a 16-byte load, ``lanes`` lanes a row (32 / lanes
    rows a warp), ``steps`` vectors a lane, ``rows_per_block`` rows a block
    of 8 warps (a lane group takes two rows at once where a lane holds at
    most 16 values of a row).

    ``lanes`` is the largest power of two up to 32 that divides the row's
    vectors, unless a lane would then hold more than a warp's share of
    ``MAX_VALUES``: then a whole warp, the last vectors of the row masked.
    Raises ``ValueError`` for a width that is no multiple of the vector (every
    width of both models is one) or wider than a warp's registers take.
    """
    vec = 16 // itemsize
    max_steps = MAX_VALUES // (32 * vec)
    vectors = width // vec
    lanes = 32
    while vectors and vectors % lanes:
        lanes //= 2
    if -(-vectors // lanes) > max_steps:
        lanes = 32
    steps = -(-vectors // lanes)
    if width < 1 or width % vec or steps > max_steps:
        raise ValueError(f"the row-norm kernel takes rows of {vec} to {MAX_VALUES} values, "
                         f"a multiple of {vec}; got {width}")
    per_group = 2 if steps * vec <= 16 else 1
    return {"vec": vec, "lanes": lanes, "steps": steps,
            "rows_per_block": WARPS * (32 // lanes) * per_group}


def backward_plan(width: int, x_itemsize: int, dy_itemsize: int) -> dict:
    """The backward's plan: ``plan`` of x's 16-byte vectors, or, for f32 x
    with bf16 cotangents and a width that is a multiple of 8, of 8-value
    vectors, so that each cotangent moves in 16-byte words (in 8-byte ones,
    three cotangents read 57 % of the byte bound on an H100 at widths 384 and
    1280, against 90 and 72 %)."""
    if x_itemsize == 4 and dy_itemsize == 2 and width % 8 == 0:
        return plan(width, 2)
    return plan(width, x_itemsize)


def backward_parts(rows: int, width_plan: dict, sms: int) -> int:
    """The backward's grid, and the rows of its f32 dscale partials (one a
    block): ``BACKWARD_BLOCKS_PER_SM`` blocks an SM, at most one a tile of
    rows."""
    return max(1, min(-(-rows // width_plan["rows_per_block"]), BACKWARD_BLOCKS_PER_SM * sms))


def _check(x, scale):
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"expected x [..., W] and scale [W]; got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}")


def _check_cuda(x, scale, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16) or scale.dtype != torch.float32 \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 x, an f32 scale and an f32 or bf16 output; "
                        f"got {x.dtype}, {scale.dtype}, {out_dtype}")
    plan(x.shape[-1], x.element_size())  # raises for a width it does not take


def row_norm(x, scale, centered: bool, out_dtype):
    """x [..., W] normed over W (centered LayerNorm or RMSNorm), times scale
    [W], as ``out_dtype``.

    Runs the custom op ``tdspa::row_norm`` (``kernels/ops.py``). CUDA tensors
    launch the kernel, which takes f32 or bf16 x, an f32 scale and an f32 or
    bf16 output, and rows of up to 1536 values, a multiple of a 16-byte
    vector; anything else raises (an operand off a 16-byte boundary is
    copied). Where autograd records on CUDA tensors, ``row_norm_fn`` (the
    backward kernel). CPU tensors run ``row_norm_reference`` (directly, and
    differentiably, where autograd records).
    """
    from tdspa_torch.kernels import ops

    _check(x, scale)
    if not on_cuda("row_norm", x, scale):
        if records(x, scale):
            return row_norm_reference(x, scale, centered, out_dtype)
        return ops.row_norm(x, scale, centered, out_dtype)
    _check_cuda(x, scale, out_dtype)
    if records(x, scale):
        return row_norm_fn(x, scale, centered, out_dtype)
    return ops.row_norm(x, scale, centered, out_dtype)


def launch(x, scale, centered: bool, out_dtype):
    """The forward kernel's launch on checked CUDA operands (the op's CUDA
    implementation)."""
    x, scale = aligned(x.contiguous()), aligned(scale.contiguous())
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    n, width = rows(x, "the row-norm kernel"), x.shape[-1]
    if out.numel() == 0:
        return out
    p = plan(width, x.element_size())
    build.launch("tdspa_row_norm_forward", x.device, x.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                 int(centered), n, width, p["lanes"], p["steps"])
    row_norm.launches += 1
    return out


row_norm.launches = 0


def _cotangents(x, dy) -> tuple:
    """dy as a tuple of 1 to ``MAX_COTANGENTS`` cotangents of x's shape and
    one dtype."""
    dys = (dy,) if isinstance(dy, torch.Tensor) else tuple(dy)
    if not 1 <= len(dys) <= MAX_COTANGENTS:
        raise ValueError(f"the row-norm backward sums 1 to {MAX_COTANGENTS} cotangents; "
                         f"got {len(dys)}")
    for d in dys:
        if d.shape != x.shape:
            raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(d.shape)}")
        if d.dtype != dys[0].dtype:
            raise TypeError(f"cotangents of one dtype; got {dys[0].dtype} and {d.dtype}")
    return dys


def cotangent_sum(dys):
    """The cotangents' sum in f32 (f64 for f64 ones), added in the order
    given; a single cotangent as it is."""
    if len(dys) == 1:
        return dys[0]
    compute = torch.promote_types(dys[0].dtype, torch.float32)
    total = dys[0].to(compute)
    for d in dys[1:]:
        total = total + d.to(compute)
    return total


def row_norm_backward(x, scale, dy, centered: bool):
    """(dx, dscale) for the cotangent dy of ``row_norm(x, scale, centered,
    dy.dtype)``: dx in x's dtype, dscale f32. dy may be a sequence of 1 to
    ``MAX_COTANGENTS`` cotangents of one dtype, one from each reader of the
    output: their f32 sum (``cotangent_sum``) is then the cotangent.

    CUDA tensors launch the backward kernel (``launch_backward``: f32 or bf16
    x and dy, f32 scale), which sums the cotangents in registers; CPU tensors
    run ``row_norm_backward_reference`` of ``cotangent_sum``.
    ``row_norm_backward.launches`` counts kernel launches.
    """
    dys = _cotangents(x, dy)
    if not on_cuda("row_norm_backward", x, scale, *dys):
        return row_norm_backward_reference(x, scale, cotangent_sum(dys), centered)
    _check_cuda(x, scale, dys[0].dtype)
    return launch_backward(x, scale, dys, centered)


def launch_backward(x, scale, dys, centered: bool):
    """The backward kernel's launch on checked CUDA operands (``dys``, a tuple
    of 1 to 4 cotangents): the row kernel on ``backward_parts`` blocks, then
    the sum of its per-block dscale partials."""
    x, scale = aligned(x.contiguous()), aligned(scale.contiguous())
    dys = [aligned(d.contiguous()) for d in dys]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n, width = rows(x, "the row-norm kernel"), x.shape[-1]
    if n == 0 or width == 0:
        return dx, torch.zeros(width, dtype=torch.float32, device=x.device)
    dscale = torch.empty(width, dtype=torch.float32, device=x.device)
    p = backward_plan(width, x.element_size(), dys[0].element_size())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    parts = backward_parts(n, p, sms)
    partial = torch.empty((parts, width), dtype=torch.float32, device=x.device)
    pointers = [d.data_ptr() for d in dys] + [None] * (MAX_COTANGENTS - len(dys))
    build.launch("tdspa_row_norm_backward", x.device, x.data_ptr(), scale.data_ptr(), *pointers,
                 dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), len(dys),
                 int(x.dtype == torch.bfloat16), int(dys[0].dtype == torch.bfloat16),
                 int(centered), n, width, p["lanes"], p["steps"], parts)
    row_norm_backward.launches += 1
    return dx, dscale


row_norm_backward.launches = 0


class _RowNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, centered, out_dtype):
        # Straight to the launch: the custom op's dispatch is for tracers,
        # and a recorded graph is not exported.
        ctx.save_for_backward(x, scale)
        ctx.centered = centered
        if x.is_cuda:
            return launch(x, scale, centered, out_dtype)
        return row_norm_reference(x, scale, centered, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = row_norm_backward(x, scale, dy, ctx.centered)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None, None)


def row_norm_fn(x, scale, centered: bool, out_dtype):
    """Differentiable row norm: forward the kernel on CUDA tensors,
    ``row_norm_reference`` on CPU tensors; backward
    ``row_norm_backward`` on the saved x (the backward kernel on CUDA tensors,
    ``row_norm_backward_reference`` on CPU tensors)."""
    return _RowNorm.apply(x, scale, centered, out_dtype)


class _RowNormShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, centered, out_dtype, readers):
        ctx.save_for_backward(x, scale)
        ctx.centered = centered
        if x.is_cuda:
            out = launch(x, scale, centered, out_dtype)
            row_norm_shared.launches += 1
        else:
            out = row_norm_reference(x, scale, centered, out_dtype)
        # One tensor a reader over the one output: each its own autograd edge.
        return tuple(out.view_as(out) for _ in range(readers))

    @staticmethod
    def backward(ctx, *dys):
        x, scale = ctx.saved_tensors
        dx, dscale = row_norm_backward(x, scale, dys, ctx.centered)
        if x.is_cuda:
            row_norm_shared.cotangents += len(dys)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None, None, None)


def row_norm_shared_fn(x, scale, centered: bool, out_dtype, readers: int):
    """Differentiable row norm read by ``readers`` projections: one forward
    (the kernel on CUDA tensors, ``row_norm_reference`` on CPU tensors), a
    tuple of ``readers`` tensors over its output; backward
    ``row_norm_backward`` on their cotangents (summed in f32)."""
    return _RowNormShared.apply(x, scale, centered, out_dtype, readers)


def row_norm_shared(x, scale, centered: bool, out_dtype, readers: int):
    """x normed as ``row_norm`` does, as a tuple of ``readers`` tensors in
    ``out_dtype``, one for each projection that reads the norm (1 to
    ``MAX_COTANGENTS``).

    CUDA tensors: ``row_norm_shared_fn``, one launch whose output every
    reader sees, and one backward launch that sums the readers' cotangents
    in f32. CPU tensors: the plain version, the chain this replaces on the
    card: the norm in f32 (``row_norm_reference``), then one cast a reader,
    autograd adding the readers' cotangents in f32.
    """
    _check(x, scale)
    if not 1 <= readers <= MAX_COTANGENTS:
        raise ValueError(f"a shared row norm has 1 to {MAX_COTANGENTS} readers; got {readers}")
    if not on_cuda("row_norm_shared", x, scale):
        out = row_norm_reference(x, scale, centered, torch.promote_types(x.dtype, torch.float32))
        return tuple(out.to(out_dtype) for _ in range(readers))
    _check_cuda(x, scale, out_dtype)
    return row_norm_shared_fn(x, scale, centered, out_dtype, readers)


row_norm_shared.launches = 0
row_norm_shared.cotangents = 0
