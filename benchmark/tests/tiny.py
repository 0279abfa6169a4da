"""Tiny cells for the CPU tests: the real configuration and traffic files
with every size cut down, so that a whole run takes seconds on the CPU."""

from __future__ import annotations

import copy

from benchmark.harness import spec

TINY_MODEL = dict(num_output_frames=12, num_latent_tokens=8, latent_token_dim=8,
                  num_frequencies=4, track_token_dim=16, encoder_latent_dim=16,
                  decoder_num_channels=160, qkv_size=16, num_heads=2, input_track_layers=1,
                  input_track_mlp=32, tracks_to_latents_layers=1, tracks_to_latents_mlp=32,
                  decompress_layers=1, decompress_mlp=32, readout_layers=1, readout_mlp=32,
                  dino_feature_dim=8)
TINY_TRAFFIC = {
    "tail": dict(grid=4, frames=12, height=32, width=32, dino_grid=[3, 3, 8], support=8,
                 queries=4, input_sets=2, splits=64, keep_every=2, sample_requests=4,
                 warmup_requests=1, trace={"wait": 1, "warmup": 1, "active": 2, "repeat": 1}),
    "train": dict(tracks=16, support=8, queries=8, frames=12, batches=3, checked_steps=3,
                  trace={"wait": 1, "warmup": 1, "active": 1, "repeat": 1}),
}


def cell(workload: str) -> dict:
    """The workload's cell as ``spec.cell`` finds it, cut to a tiny size."""
    out = copy.deepcopy(spec.cell(workload))
    config = out["config"]
    config.update({k: v for k, v in TINY_MODEL.items() if k in config})
    if "batch_size" in config:
        config["batch_size"] = 2
        config["encoder_scan_chunk_size"] = config["decoder_scan_chunk_size"] = 4
    out["traffic"].update(TINY_TRAFFIC[out["traffic"]["entry"]])
    return out
