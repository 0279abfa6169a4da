"""Helpers shared by the track autoencoders (port of the functions in
``tdspa/models/trajan2d.py``; the 2D ``TrackAutoEncoder`` comes later, see
ROADMAP.md).

Quirks of the trained function are kept: the bottleneck dither is the fixed
``jax.random.uniform(PRNGKey(0), shape)`` noise, reproduced bit for bit by
``tdspa_torch.utils.jax_prng``.
"""

from __future__ import annotations

import functools

import torch

from tdspa_torch.utils import jax_prng


def default_query_grid(batch_shape, num_coords: int = 2, grid_size: int = 32,
                       device="cpu") -> torch.Tensor:
    """[*B grid_size^2 num_coords] half-pixel-centered grid at t=0, x fastest."""
    centers = torch.arange(grid_size, device=device) / grid_size + 1.0 / (2 * grid_size)
    qy, qx = torch.meshgrid(centers, centers, indexing="ij")
    coords = [qx, qy] + [torch.zeros_like(qx)] * (num_coords - 2)
    grid = torch.stack(coords, dim=-1).reshape(-1, num_coords)
    return grid.expand(tuple(batch_shape) + grid.shape)


def append_time_feature(latents, query_frame, num_slots: int = 128, stride: int = 5):
    """Append a time-conditioned ``num_slots``-channel slice of each latent.

    Appendix channel d is latent channel ``stride * t + d`` when in range,
    else 0 (the reference's ``eye(128, C, 5*t)`` product, as a gather).

    Args:
      latents: float[*B Q N C] per-query latents.
      query_frame: int[*B Q] frame index per query.

    Returns:
      float[*B Q N C+num_slots].
    """
    channels = latents.shape[-1]
    idx = (query_frame * stride)[..., None, None] + torch.arange(
        num_slots, device=latents.device
    )  # [*B Q 1 S]
    valid = idx < channels
    index = idx.clamp(0, channels - 1).expand(latents.shape[:-1] + (num_slots,))
    gathered = torch.gather(latents, -1, index)
    to_append = torch.where(valid, gathered, torch.zeros((), dtype=latents.dtype,
                                                         device=latents.device))
    return torch.cat([latents, to_append], dim=-1)


@functools.lru_cache(maxsize=8)
def _dither(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(0), shape)``, computed once per shape/device."""
    return torch.from_numpy(jax_prng.uniform(shape)).to(device)


def quantize_latents(latents: torch.Tensor, levels: float = 128.0) -> torch.Tensor:
    """Clip to [-1, 1] and round to a 1/levels grid with the fixed dither."""
    latents = latents.clamp(-1.0, 1.0)
    latents_disc = torch.round(latents * levels) / levels
    noise = _dither(tuple(latents.shape), latents.device)
    latents_disc = latents_disc + noise / levels - 1.0 / (2 * levels)
    # Straight-through form of the reference (forward value == latents_disc).
    return latents - (latents - latents_disc).detach()
