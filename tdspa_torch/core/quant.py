"""Dynamic int8 quantisation of the transformer projections (port of
``tdspa/core/quant.py``).

Activations get one scale per row (token), weights one per output column,
both ``max|.| / 127``; the int8 product is summed exactly and dequantised
in f32. ``QuantDense`` / ``QuantDenseGeneral`` declare the same parameters
as the port's ``Dense`` / ``DenseGeneral`` (flax names ``kernel``, ``bias``,
f32), so one checkpoint serves both paths. Unlike those layers they do not
cast their input to a compute dtype: they quantise the caller's values, add
the bias in f32 and return f32. An inference knob (``quantize=True`` on the
stacks and the model).
"""

from __future__ import annotations

import math

import torch

from tdspa_torch.core.attention import DenseGeneral
from tdspa_torch.kernels.quant_matmul import dynamic_int8, quant_matmul

__all__ = ["dynamic_int8", "int8_matmul", "QuantDense", "QuantDenseGeneral"]


# x [..., K] @ w [K, N] with dynamic int8 operands -> [..., N] f32, under
# the JAX package's name: CUDA tensors launch the kernel, CPU tensors run its
# plain version, which for an f32 x equals JAX's XLA path.
int8_matmul = quant_matmul


class QuantDenseGeneral(DenseGeneral):
    """``DenseGeneral``'s parameters with the int8 product: contracts the
    trailing ``in_shape`` (flattened to one K) into ``out_shape``."""

    def __init__(self, in_shape, out_shape, use_bias: bool, device):
        super().__init__(in_shape, out_shape, use_bias, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        y = int8_matmul(x.reshape(lead + (n_in,)), self.kernel.reshape(n_in, n_out))
        if self.bias is not None:
            y = y + self.bias.reshape(n_out)
        return y.reshape(lead + self.out_shape)


def QuantDense(in_features: int, out_features: int, device) -> QuantDenseGeneral:
    return QuantDenseGeneral((in_features,), (out_features,), True, device)
