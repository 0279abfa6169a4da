"""Coordinate embedding and learnable-state primitives (port of
``tdspa/core/embeddings.py``).

Third-octave frequency ladder ``2**(i/3)``, cos computed as ``sin(x + pi/2)``,
and a coordinate-major flatten: per coordinate the F sin values, then the F
cos values. The parameter is named ``state_init`` as in the flax tree.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def sinusoidal_embedding(inputs: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    """float[*B C] -> float[*B C*2F] Fourier features over ``2**(i/3)``."""
    dtype = inputs.dtype if inputs.is_floating_point() else torch.float32
    # Made on the CPU and moved: a traced program keeps it as a constant.
    scales = torch.tensor([2 ** (i / 3) for i in range(num_frequencies)], dtype=dtype).to(
        inputs.device)
    x = inputs[..., None] * scales  # (..., C, F)
    out = torch.sin(torch.cat([x, x + 0.5 * math.pi], dim=-1))  # (..., C, 2F)
    return out.flatten(-2)


class ParamStateInit(nn.Module):
    """A learnable tensor ~ Normal(0, 1) broadcast over leading batch dims."""

    def __init__(self, shape: tuple[int, ...], device: torch.device):
        super().__init__()
        self.state_init = nn.Parameter(torch.empty(shape, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.state_init.normal_(0.0, 1.0, generator=generator)

    def forward(self, batch_shape) -> torch.Tensor:
        return self.state_init.expand(tuple(batch_shape) + tuple(self.state_init.shape))
