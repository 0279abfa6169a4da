"""Tiny-model factory and a numpy-seeded synthetic batch for tests.

The batch is plain numpy so the same arrays feed the JAX package and the
port; ``to_torch`` moves it onto a device.
"""

from __future__ import annotations

import numpy as np
import torch

from tdspa_torch.models import TrackAutoEncoder, TrackAutoEncoder3D

TINY_2D = dict(
    num_latent_tokens=8,
    latent_token_dim=8,
    num_frequencies=4,
    track_token_dim=16,
    encoder_latent_dim=16,
    decoder_num_channels=160,  # must be > 128 (time-feature appendix)
    qkv_size=16,
    num_heads=2,
    input_track_layers=1,
    input_track_mlp=32,
    tracks_to_latents_layers=1,
    tracks_to_latents_mlp=32,
    decompress_layers=1,
    decompress_mlp=32,
    readout_layers=1,
    readout_mlp=32,
)

TINY_3D = dict(TINY_2D)


def tiny_model_2d(num_output_frames: int = 12, **overrides) -> TrackAutoEncoder:
    return TrackAutoEncoder(num_output_frames=num_output_frames, **{**TINY_2D, **overrides})


def tiny_model_3d(num_output_frames: int = 12, **overrides) -> TrackAutoEncoder3D:
    return TrackAutoEncoder3D(num_output_frames=num_output_frames, **{**TINY_3D, **overrides})


def synthetic_batch(seed: int = 0, batch: int = 2, num_support: int = 8,
                    num_queries: int = 4, num_frames: int = 12, num_coords: int = 3,
                    with_features: bool = False, dino_dim: int = 768,
                    depth_dim: int = 256) -> dict[str, np.ndarray]:
    """Smooth sinusoidal tracks, random visibility, queries at random frames."""
    rng = np.random.default_rng(seed)

    def tracks(n):
        center, radius, phase, freq = (
            rng.uniform(size=(batch, n, 1, num_coords)) for _ in range(4)
        )
        t = np.arange(num_frames)[None, None, :, None] / num_frames
        return (center + 0.1 * radius * np.sin(
            2 * np.pi * (4 * freq + 1) * t + 2 * np.pi * phase)).astype(np.float32)

    support, query = tracks(num_support), tracks(num_queries)
    qt = rng.integers(0, num_frames, size=(batch, num_queries))
    coords_at_t = np.take_along_axis(query, qt[..., None, None], axis=-2)[..., 0, :]
    out = {
        "support_tracks": support,
        "support_tracks_visible": (
            rng.uniform(size=(batch, num_support, num_frames, 1)) > 0.2
        ).astype(np.float32),
        "query_points": np.concatenate(
            [qt[..., None].astype(np.float32), coords_at_t], axis=-1
        ),
        "query_tracks": query,
        "query_tracks_visible": (
            rng.uniform(size=(batch, num_queries, num_frames, 1)) > 0.2
        ).astype(np.float32),
        "boundary_frame": np.full((batch,), num_frames, np.int32),
    }
    if with_features:
        out["dino_features"] = (
            0.1 * rng.standard_normal((batch, num_support, num_frames, dino_dim))
        ).astype(np.float32)
        out["depth_features"] = (
            0.1 * rng.standard_normal((batch, num_support, num_frames, depth_dim))
        ).astype(np.float32)
    return out


def to_torch(batch: dict, device="cpu") -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
