"""The ViT block's memory-bound stages: CUDA kernel wrappers + their plain versions.

``features/vit.py::_Block`` ends each side of a block in one row pass and
gates its SwiGLU in one elementwise pass:

* ``vit_residual_norm``: the residual prologue ``x' = x + (h + bias) *
  layer_scale`` (h the output projection's GEMM without its bias, in the
  compute dtype; the layer scale cast to the stream's dtype), and a flax
  LayerNorm of ``x'`` with scale and bias (f32 statistics, fast variance),
  each optional. A block call launches it three times: norm1; the attention's
  residual and norm2 together; the FFN's residual. ``Dinov2``'s final norm is
  a fourth.
* ``swiglu_gate``: ``silu(y1 + b1) * (y2 + b2)`` over the halves of the
  SwiGLU's first GEMM without its bias.

No TPU kernel computes them: XLA fuses these stages into their neighbours,
where eager PyTorch runs each as several passes over the tensor.
``tdspa_torch/csrc/vit_block.cu`` moves each operand once.

CUDA tensors launch the kernels; CPU tensors run the plain versions, which
are the eager chain the block ran before the kernels, bit for bit. Neither
falls back to the other. Both devices refuse the same operands (rows wider
than 1536 values or no multiple of 8, mismatched shapes, dtypes the kernels
do not take), so a ViT that runs on the CPU runs on the card. The kernels are
forward-only, as the ViT's attention kernel is. ``vit_residual_norm.launches``
and ``swiglu_gate.launches`` count kernel launches.
"""

from __future__ import annotations

import functools

import torch

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import aligned, forward_only, on_cuda, rows
from tdspa_torch.kernels.norm import row_norm_reference

VEC = 8  # values of a row a lane moves at once: 16 bytes of bf16, 32 of f32
MAX_VALUES = 1536  # of a row that one warp's registers hold
DTYPES = (torch.float32, torch.bfloat16)


def vit_residual_norm_reference(x, residual=None, norm=None, out_dtype=torch.float32):
    """Plain PyTorch version of ``vit_residual_norm``.

    ``residual`` (h, bias, layer_scale): ``x' = x + (h + bias.to(h.dtype)) *
    layer_scale.to(x.dtype)``, each operation in PyTorch's promotion, as the
    output projection's bias add, the layer scale and the residual sum ran.
    ``norm`` (scale, bias, eps): flax's LayerNorm of ``x'`` (f32 statistics,
    ``E[x^2] - E[x]^2`` clipped at 0), rounded once to ``out_dtype``.
    Returns ``(x', norm)`` with both, else the one computed.
    """
    if residual is not None:
        h, bias, layer_scale = residual
        x = x + (h + bias.to(h.dtype)) * layer_scale.to(x.dtype)
    if norm is None:
        return x
    scale, bias, eps = norm
    out = row_norm_reference(x, scale, True, out_dtype, bias, eps)
    return out if residual is None else (x, out)


def swiglu_gate_reference(y, bias):
    """Plain PyTorch version of ``swiglu_gate``: ``F.silu(y1) * y2`` on the
    halves of ``y + bias.to(y.dtype)`` (y [..., 2F] -> [..., F])."""
    y1, y2 = (y + bias.to(y.dtype)).chunk(2, dim=-1)
    return torch.nn.functional.silu(y1) * y2


@functools.cache
def plan(width: int) -> dict:
    """How ``csrc/vit_block.cu`` holds a row of ``width`` values: ``lanes``
    lanes a row (32 / lanes rows a warp), ``steps`` vectors of ``VEC`` values
    a lane.

    ``lanes`` is the largest power of two up to 32 that divides the row's
    vectors, unless a lane would then hold more than a warp's share of
    ``MAX_VALUES``: then a whole warp, the last vectors of the row masked.
    Raises ``ValueError`` for a width that is no multiple of ``VEC`` or wider
    than ``MAX_VALUES``.
    """
    max_steps = MAX_VALUES // (32 * VEC)
    vectors = width // VEC
    lanes = 32
    while vectors and vectors % lanes:
        lanes //= 2
    if -(-vectors // lanes) > max_steps:
        lanes = 32
    steps = -(-vectors // lanes)
    if width < 1 or width % VEC or steps > max_steps:
        raise ValueError(f"the ViT row kernel takes rows of {VEC} to {MAX_VALUES} values, "
                         f"a multiple of {VEC}; got {width}")
    return {"lanes": lanes, "steps": steps}


def _vector(name, t, width, device):
    if t.shape != (width,) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be f32 [{width}] on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_row_operands(x, residual, norm, out_dtype):
    if residual is None and norm is None:
        raise ValueError("vit_residual_norm needs a residual, a norm or both")
    if x.dim() < 1 or x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise ValueError(f"x must be f32 or bf16 [..., W] and the norm's output f32 or bf16; "
                         f"got {x.dtype} {tuple(x.shape)}, {out_dtype}")
    width = x.shape[-1]
    plan(width)
    if residual is not None:
        h, bias, layer_scale = residual
        if h.shape != x.shape or h.device != x.device or h.dtype not in DTYPES:
            raise ValueError(f"h must be f32 or bf16 {tuple(x.shape)} on {x.device}; got "
                             f"{h.dtype} {tuple(h.shape)} on {h.device}")
        if torch.promote_types(h.dtype, x.dtype) != x.dtype:
            raise ValueError(f"h ({h.dtype}) must be no wider than the stream x ({x.dtype})")
        _vector("the bias", bias, width, x.device)
        _vector("the layer scale", layer_scale, width, x.device)
    if norm is not None:
        _vector("the norm's scale", norm[0], width, x.device)
        _vector("the norm's bias", norm[1], width, x.device)


def vit_residual_norm(x, residual=None, norm=None, out_dtype=torch.float32):
    """The residual prologue and/or LayerNorm of x [..., W] over W
    (``vit_residual_norm_reference``): ``residual`` (h [..., W] in f32 or
    bf16, no wider than x; bias and layer scale f32 [W]), ``norm`` (scale and
    bias f32 [W], eps), the norm written as ``out_dtype`` (f32 or bf16).

    CUDA tensors launch ``csrc/vit_block.cu`` (x' in x's dtype, equal to the
    plain version's bit for bit; the norm within an ulp of its dtype); CPU
    tensors run the plain version. Raises ``ValueError`` for operands the
    kernel does not take (on either device), ``NotImplementedError`` where
    autograd would record on CUDA tensors.
    """
    _check_row_operands(x, residual, norm, out_dtype)
    if not on_cuda("vit_residual_norm", x):
        return vit_residual_norm_reference(x, residual, norm, out_dtype)
    forward_only("vit_residual_norm", x, *(residual or ()), *(norm or ())[:2])
    return launch_residual_norm(x, residual, norm, out_dtype)


def swiglu_gate(y, bias):
    """``silu(y1 + b1) * (y2 + b2)`` on the halves of y [..., 2F] (f32 or
    bf16, F a multiple of a 16-byte word's values) with bias f32 [2F], in y's
    dtype (``swiglu_gate_reference``).

    CUDA tensors launch ``csrc/vit_block.cu``; CPU tensors run the plain
    version. Raises ``ValueError`` for operands the kernel does not take (on
    either device), ``NotImplementedError`` where autograd would record on
    CUDA tensors.
    """
    if y.dim() < 1 or y.dtype not in DTYPES:
        raise ValueError(f"y must be f32 or bf16 [..., 2F]; got {y.dtype} {tuple(y.shape)}")
    hidden, vec = y.shape[-1] // 2, 16 // y.element_size()
    if y.shape[-1] != 2 * hidden or hidden < 1 or hidden % vec:
        raise ValueError(f"the gate takes y [..., 2F] with F a multiple of {vec}; got "
                         f"{tuple(y.shape)}")
    _vector("the bias", bias, 2 * hidden, y.device)
    if not on_cuda("swiglu_gate", y):
        return swiglu_gate_reference(y, bias)
    forward_only("swiglu_gate", y, bias)
    return launch_gate(y, bias)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_residual_norm(x, residual, norm, out_dtype):
    """The row kernel's launch on checked CUDA operands."""
    x = aligned(x.contiguous())
    n, width = rows(x, "the ViT row kernel"), x.shape[-1]
    h = bias = layer_scale = x_out = scale = norm_bias = out = None
    eps = 0.0
    if residual is not None:
        h, bias, layer_scale = (aligned(t.contiguous()) for t in residual)
        x_out = torch.empty_like(x)
    if norm is not None:
        scale, norm_bias = (aligned(t.contiguous()) for t in norm[:2])
        eps = float(norm[2])
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if n:
        p = plan(width)
        build.launch(
            "tdspa_vit_residual_norm", x.device, x.data_ptr(), _ptr(h), _ptr(bias),
            _ptr(layer_scale), _ptr(x_out), _ptr(scale), _ptr(norm_bias), _ptr(out),
            int(x.dtype == torch.bfloat16), int((x if h is None else h).dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), eps, n, width, p["lanes"], p["steps"],
        )
        vit_residual_norm.launches += 1
    if norm is None:
        return x_out
    return out if residual is None else (x_out, out)


vit_residual_norm.launches = 0


def launch_gate(y, bias):
    """The gate kernel's launch on checked CUDA operands."""
    y, bias = aligned(y.contiguous()), aligned(bias.contiguous())
    hidden = y.shape[-1] // 2
    n = rows(y, "the SwiGLU gate kernel")
    out = torch.empty(y.shape[:-1] + (hidden,), dtype=y.dtype, device=y.device)
    if n:
        build.launch("tdspa_swiglu_gate", y.device, y.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), int(y.dtype == torch.bfloat16), n, hidden)
        swiglu_gate.launches += 1
    return out


swiglu_gate.launches = 0
