"""The kernels of the inference tail as ``torch.library`` custom ops.

``torch.export`` cannot trace a ctypes launch on ``data_ptr()``, so the five
kernels that an exported tail reaches are registered here as operators of
the ``tdspa`` namespace:

* ``tdspa::fused_masked_attention`` (``csrc/attention.cu``),
* ``tdspa::bilinear_sample`` (``csrc/bilinear.cu``),
* ``tdspa::quant_matmul`` (``csrc/quant_matmul.cu``),
* ``tdspa::fused_transformer_block`` (``csrc/block.cu``),
* ``tdspa::row_norm`` (``csrc/norm.cu``).

Each has a CPU implementation, the kernel's plain version; a CUDA
implementation, the kernel's launch; and a fake implementation that gives
the output's shape and dtype to a tracer. Neither real implementation falls
back to the other. The wrappers in ``kernels/{attention,bilinear,
quant_matmul,block,norm}.py`` check their arguments and call these ops; each
wrapper's ``launches`` counter counts in the CUDA implementation, so that an
exported program's launches count too. What a launch caches (the int8
weights, the block's flattened operands) is cached inside the CUDA
implementation, keyed on the real tensors it is given, never at trace time.

The ops have no autograd formula: a backward through one raises. Training
differentiates through ``kernels/attention.py::fused_attention_fn`` and
``kernels/norm.py::row_norm_fn``, and on CPU tensors that autograd records
the wrappers call the plain versions directly. Importing this module
registers the ops and imports no model code, so a process that only loads an
exported program imports it alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from tdspa_torch.kernels import attention, bilinear, block, norm
from tdspa_torch.kernels import quant_matmul as quant_matmul_lib


@torch.library.custom_op("tdspa::fused_masked_attention", mutates_args=(), device_types="cpu")
def fused_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: Optional[torch.Tensor],
                           out_dtype: torch.dtype) -> torch.Tensor:
    return attention.attention_reference(q, k, v, key_mask, out_dtype)


@fused_masked_attention.register_kernel("cuda")
def _(q, k, v, key_mask, out_dtype):
    return attention.launch(q, k, v, key_mask, out_dtype)


@fused_masked_attention.register_fake
def _(q, k, v, key_mask, out_dtype):
    return q.new_empty(q.shape, dtype=out_dtype)


@torch.library.custom_op("tdspa::bilinear_sample", mutates_args=(), device_types="cpu")
def bilinear_sample(grid: torch.Tensor, coords: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    return bilinear.bilinear_sample_reference(grid, coords, out_dtype)


@bilinear_sample.register_kernel("cuda")
def _(grid, coords, out_dtype):
    return bilinear.launch(grid, coords, out_dtype)


@bilinear_sample.register_fake
def _(grid, coords, out_dtype):
    return grid.new_empty((coords.shape[0], grid.shape[0], grid.shape[3]), dtype=out_dtype)


@torch.library.custom_op("tdspa::quant_matmul", mutates_args=(), device_types="cpu")
def quant_matmul(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return quant_matmul_lib.quant_matmul_reference(x2d, w)


@quant_matmul.register_kernel("cuda")
def _(x2d, w):
    wq, ws = quant_matmul_lib.cached_quantized_weight(w)
    out = quant_matmul_lib.launch(x2d.contiguous(), wq, ws)
    quant_matmul_lib.quant_matmul.launches += 1
    return out


@quant_matmul.register_fake
def _(x2d, w):
    return x2d.new_empty((x2d.shape[0], w.shape[1]), dtype=torch.float32)


@torch.library.custom_op("tdspa::fused_transformer_block", mutates_args=(),
                         device_types="cpu")
def fused_transformer_block(x: torch.Tensor, params: list[torch.Tensor], heads: int,
                            out_dtype: torch.dtype) -> torch.Tensor:
    named = dict(zip(block.PARAMS, params))
    return block.block_reference(x, block.flatten_block_params(named), heads, out_dtype)


@fused_transformer_block.register_kernel("cuda")
def _(x, params, heads, out_dtype):
    return block.launch(x, block.cached_operands(params), heads, out_dtype)


@fused_transformer_block.register_fake
def _(x, params, heads, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


@torch.library.custom_op("tdspa::row_norm", mutates_args=(), device_types="cpu")
def row_norm(x: torch.Tensor, scale: torch.Tensor, centered: bool,
             out_dtype: torch.dtype) -> torch.Tensor:
    return norm.row_norm_reference(x, scale, centered, out_dtype)


@row_norm.register_kernel("cuda")
def _(x, scale, centered, out_dtype):
    return norm.launch(x, scale, centered, out_dtype)


@row_norm.register_fake
def _(x, scale, centered, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)
