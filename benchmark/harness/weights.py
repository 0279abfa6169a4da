"""Weights made from the seed on the device in a few large calls: one normal
draw for every weight, then one scale and one offset per element (laws of
``reference/model.py::param_shapes``), split into the named tensors."""

from __future__ import annotations

import math

import torch

LAWS = {  # law -> (scale, offset); a kernel's scale is 1/sqrt(fan_in)
    "kernel": (None, 0.0),
    "bias": (0.02, 0.0),
    "scale": (0.1, 1.0),
    "state": (1.0, 0.0),
}


def substream(seed: int, name: str) -> int:
    """A seed of its own for each use of the run's seed, in 63 bits."""
    return (seed * 1_000_003 + sum(ord(c) * 131 ** i for i, c in enumerate(name))) % (2 ** 63)


def make(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    names = list(shapes)
    sizes = [math.prod(shapes[n][0]) for n in names]
    scale, offset = [], []
    for n in names:
        _, law, fan_in = shapes[n]
        s, o = LAWS[law]
        scale.append(1.0 / math.sqrt(fan_in) if s is None else s)
        offset.append(o)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(substream(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(scale, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(offset, device=device), counts))
    return {n: part.view(shapes[n][0]) for n, part in zip(names, torch.split(flat, sizes))}
