"""Matrix-product and attention flops of one forward of a track autoencoder
(2 flops a multiply-add), from the shapes the plain reference
(``benchmark/reference/model.py``) computes at a cell's sizes. Norms,
softmax, GELU and sums are not counted, nor any recompute or padding.
"""

from __future__ import annotations


def _stack(items: int, tokens: int, width: int, mlp: int, qkv: int, layers: int,
           kv_tokens: int = 0, kv_width: int = 0) -> float:
    """One stack of parallel blocks over ``items`` sequences of ``tokens``."""
    n = items * tokens
    layer = 2.0 * n * width * qkv * 3 + 2.0 * n * qkv * width  # q, k, v, out
    layer += 4.0 * items * tokens * tokens * qkv  # q k^T and p v
    layer += 4.0 * n * width * mlp  # MLP in and out
    if kv_tokens:
        m = items * kv_tokens
        layer += 2.0 * n * width * qkv + 4.0 * m * kv_width * qkv + 2.0 * n * qkv * width
        layer += 4.0 * items * tokens * kv_tokens * qkv
    return layers * layer


def forward_flops(cfg: dict, batch: int, support: int, queries: int, frames: int) -> float:
    three_d = cfg["architecture"] == "TrackAutoEncoder3D"
    coords = 3 if three_d else 2
    two_f = 2 * cfg["num_frequencies"]
    qkv = cfg["qkv_size"]
    width = cfg["track_token_dim"]
    latents, lat_width = cfg["num_latent_tokens"], cfg["encoder_latent_dim"]
    channels = cfg["decoder_num_channels"]
    frame_tokens = support * frames
    flops = 2.0 * frame_tokens * (coords + 1) * two_f * width
    if three_d:
        if cfg["use_dino"]:
            flops += 2.0 * frame_tokens * cfg["dino_feature_dim"] * width
        if cfg["use_depth"]:
            flops += 2.0 * frame_tokens * cfg["depth_feature_dim"] * width
    tokens = frames + (1 if three_d else 0)
    flops += _stack(support, tokens, width, cfg["input_track_mlp"], qkv,
                    cfg["input_track_layers"])
    flops += _stack(1, latents, lat_width, cfg["tracks_to_latents_mlp"], qkv,
                    cfg["tracks_to_latents_layers"], kv_tokens=support, kv_width=width)
    flops += 2.0 * latents * lat_width * cfg["latent_token_dim"]
    flops += 2.0 * latents * cfg["latent_token_dim"] * (channels - 128)
    flops += _stack(1, latents, channels - 128, cfg["decompress_mlp"], qkv,
                    cfg["decompress_layers"])
    flops += 2.0 * queries * (coords * two_f + 1) * two_f * channels
    flops += _stack(queries, latents + 1, channels, cfg["readout_mlp"], qkv,
                    cfg["readout_layers"])
    flops += 2.0 * queries * channels * cfg["num_output_frames"] * 4
    return batch * flops
