"""The precision the plain reference computes its products in.

``f32``: every product in float32 (TF32 is switched off by the caller on a
GPU). ``fp8`` is the control of the check that decides ``correct``, the step
below the bfloat16 the configurations state: the same reference with each
operand of every matrix product (projections, MLPs, attention's two
products) rounded to float8 e4m3 under one scale per tensor (its largest
magnitude onto e4m3's largest, 448) before an f32 accumulation, as an fp8
GEMM computes; where autograd records, the gradient that flows back into
each rounded operand is rounded to e5m2 the same way, as fp8 training does.
Everything else (norms, softmax, GELU, sums) stays float32.
"""

from __future__ import annotations

import torch

MODES = ("f32", "fp8")


def _scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled(x.float(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g.float(), torch.float8_e5m2)


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x.float()
        return _Round.apply(x)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N] -> [..., N] in f32."""
        return self.round(x) @ self.round(w)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.round(a), self.round(b))
