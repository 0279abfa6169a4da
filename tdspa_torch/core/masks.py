"""Attention-mask construction for ragged track sets (port of
``tdspa/core/masks.py``).

Masks gate attention *keys* only: every query row is identical, so the
encoders' masks are built as key rows with a broadcast query axis of 1. That
key-only form is what lets the fused attention kernel serve the encoders.
"""

from __future__ import annotations

import torch


def readout_temporal_mask(visible: torch.Tensor, boundary_frame: torch.Tensor) -> torch.Tensor:
    """bool[*B N 1 T+1] key mask for [readout | frame tokens] self-attention.

    Key 0 (the readout token) is always attendable; key k+1 is attendable iff
    ``visible[k]`` and ``k < boundary_frame``.
    """
    num_frames = visible.shape[-2]
    vis = visible[..., 0].bool()  # [*B N T]
    time = torch.arange(num_frames, device=visible.device)
    in_bounds = time < boundary_frame[..., None, None]  # [*B 1 T]
    key_ok = vis & in_bounds
    readout_col = torch.ones_like(key_ok[..., :1])
    keys = torch.cat([readout_col, key_ok], dim=-1)  # [*B N T+1]
    return keys[..., None, :]


def visibility_key_mask(visible: torch.Tensor) -> torch.Tensor:
    """bool[*B N T T]: square per-track mask whose column k is frame k's visibility."""
    vis = visible[..., 0].bool()
    return vis[..., None, :].expand(vis.shape + vis.shape[-1:])


def track_temporal_mask(visible: torch.Tensor, boundary_frame: torch.Tensor) -> torch.Tensor:
    """bool[*B N 1 T] key mask over each track's frame tokens (the 2D encoder's).

    Key k is attendable iff ``visible[k]`` and ``k < boundary_frame``.
    """
    vis = visible[..., 0].bool()  # [*B N T]
    time = torch.arange(visible.shape[-2], device=visible.device)
    in_bounds = time < boundary_frame[..., None, None]  # [*B 1 T]
    return (vis & in_bounds)[..., None, :]
