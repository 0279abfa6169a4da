"""The attention calls of one forward of a track autoencoder, as the plain
reference (``benchmark/reference/model.py``) makes them at a cell's sizes,
and the least time of the fused attention's forward and backward at each.

A call is (name, items B, query rows S, keys K, heads H, head size D,
masked). The bound is the larger of bytes over the HBM peak and flops over
the bf16 tensor-core peak (``peaks.py``): q, k, v read once in bf16, the key
mask a byte a key, the output written once (f32); forward 4 B H S K D flops
(two products); backward q, k, v (bf16) and the f32 cotangent read once, the
three bf16 gradients written once, 10 B H S K D flops (five products).
"""

from __future__ import annotations

from benchmark.harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def forward_calls(cfg: dict, batch: int, support: int, queries: int, frames: int) -> list:
    """Every attention call of one forward of ``batch`` examples."""
    heads = cfg["num_heads"]
    depth = cfg["qkv_size"] // heads
    latents = cfg["num_latent_tokens"]
    tokens = frames + (1 if cfg["architecture"] == "TrackAutoEncoder3D" else 0)
    calls = []
    calls += [("encoder", batch * support, tokens, tokens, heads, depth, True)] * \
        cfg["input_track_layers"]
    for _ in range(cfg["tracks_to_latents_layers"]):
        calls += [("latents_self", batch, latents, latents, heads, depth, False),
                  ("latents_cross", batch, latents, support, heads, depth, False)]
    calls += [("decompress", batch, latents, latents, heads, depth, False)] * \
        cfg["decompress_layers"]
    calls += [("readout", batch * queries, latents + 1, latents + 1, heads, depth, False)] * \
        cfg["readout_layers"]
    return calls


def forward_bound_s(call, out_bytes: int = 4) -> float:
    _, b, s, k, h, d, masked = call
    nbytes = 2 * h * d * b * (s + 2 * k) + out_bytes * b * s * h * d + (b * k if masked else 0)
    flops = 4.0 * b * h * s * k * d
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def backward_bound_s(call) -> float:
    _, b, s, k, h, d, masked = call
    nbytes = b * h * d * (8 * s + 8 * k) + (b * k if masked else 0)
    flops = 10.0 * b * h * s * k * d
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
