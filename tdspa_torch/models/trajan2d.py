"""TRAJAN: the 2D point-track autoencoder (port of
``tdspa/models/trajan2d.py``), and the helpers both track autoencoders share.

Kept from the JAX package because they are part of the trained function:
the dead decoder time term ``query_frame // time_scale_factor`` (0 for every
frame < 150; Q3), the visibility-weighted mean pooling of each track's frame
tokens with ``max(1, sum(vis))``, ``certain_logits`` from the predictor, and
the bottleneck's fixed dither ``jax.random.uniform(PRNGKey(0), shape)``,
reproduced bit for bit by ``tdspa_torch.utils.jax_prng``.

The JAX model declares an ``input_readout_token`` it never calls (Q5). Flax
creates a submodule's parameters only when it is called, so that token is
not in the flax parameter tree (68,333,080 parameters at the defaults) and
the port, whose ``state_dict`` is that tree, has no such parameter.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
import torch.utils.checkpoint

from tdspa_torch.core.attention import Dense, TransformerStack, reset_parameters
from tdspa_torch.core.embeddings import ParamStateInit, sinusoidal_embedding
from tdspa_torch.core.masks import track_temporal_mask
from tdspa_torch.models.containers import (
    TrackAutoEncoderDecoderContext,
    TrackAutoEncoderResults,
)
from tdspa_torch.utils import jax_prng
from tdspa_torch.utils.device import resolve_device


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
def _cached_dither(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(jax_prng.uniform(shape)).to(device)


def _dither(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(0), shape)``, computed once per shape/device.

    A program being traced (``torch.export``) makes its own copy, which
    becomes a constant of the graph; the cache never holds a traced tensor.
    """
    if torch.compiler.is_compiling():
        return torch.from_numpy(jax_prng.uniform(shape)).to(device)
    return _cached_dither(shape, device)


def quantize_latents(latents: torch.Tensor, levels: float = 128.0,
                     dither_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Clip to [-1, 1] and round to a 1/levels grid with the fixed dither.

    ``dither_rows=(offset, total)``: the latents are rows ``offset`` on of a
    batch of ``total`` (a rank's data shard), and take those rows of that
    batch's dither, as the sharded JAX program does.
    """
    latents = latents.clamp(-1.0, 1.0)
    latents_disc = torch.round(latents * levels) / levels
    if dither_rows is None:
        noise = _dither(tuple(latents.shape), latents.device)
    else:
        offset, total = dither_rows
        noise = _dither((total,) + tuple(latents.shape[1:]), latents.device)
        noise = noise[offset : offset + latents.shape[0]]
    latents_disc = latents_disc + noise / levels - 1.0 / (2 * levels)
    # Straight-through form of the reference (forward value == latents_disc).
    return latents - (latents - latents_disc).detach()


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass instead
    of kept (flax's ``nn.remat``) while autograd records; a plain call
    otherwise, so inference is unchanged."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def chunked_decode(model, latents, inputs, dither_rows=None) -> TrackAutoEncoderResults:
    """Both models' decoder: one ``decode`` over every query, or one per
    ``decoder_scan_chunk_size`` queries (the JAX ``nn.scan``), each with its
    context and itself rematerialised as in JAX; the chunks' outputs equal
    the unchunked ones. ``dither_rows`` as in ``quantize_latents``."""
    h = model.decoder_scan_chunk_size
    decode = functools.partial(model.decode, dither_rows=dither_rows)
    if h is None:
        return remat(decode, latents, remat(model.get_decoder_context, inputs))
    query_points = inputs["query_points"]
    if query_points.shape[-2] % h:
        raise ValueError(
            f"decoder_scan_chunk_size={h} must divide the query count "
            f"{query_points.shape[-2]}"
        )
    parts = [
        remat(decode, latents, remat(
            model.get_decoder_context, {**inputs, "query_points": query_points[..., i : i + h, :]}
        ))
        for i in range(0, query_points.shape[-2], h)
    ]
    return TrackAutoEncoderResults(
        tracks=torch.cat([p.tracks for p in parts], dim=-3),
        visible_logits=torch.cat([p.visible_logits for p in parts], dim=-3),
        certain_logits=torch.cat([p.certain_logits for p in parts], dim=-3),
    )


class TrackAutoEncoder(nn.Module):
    """TRAJAN 2D track autoencoder (68,333,080 parameters at defaults).

    Parameters are created on ``device`` (GPU unless ``device="cpu"``) and
    initialised from ``torch.Generator(device).manual_seed(seed)`` with the
    flax initialisers' laws. ``fused_attention`` runs the attention of every
    stack through ``csrc/attention.cu`` on CUDA tensors (differentiable: its
    backward is JAX's recompute); ``quantize`` and ``fused_block`` are the
    inference knobs of ``TrackAutoEncoder3D``. ``encoder_scan_chunk_size`` /
    ``decoder_scan_chunk_size`` encode support tracks / decode queries in
    chunks, recomputed in the backward pass as JAX's ``nn.remat`` does.
    """

    def __init__(
        self,
        num_output_frames: int = 150,
        num_latent_tokens: int = 128,
        latent_token_dim: int = 64,
        num_frequencies: int = 32,
        track_scale_factor: float = 1.0,
        time_scale_factor: float = 150.0,
        track_token_dim: int = 256,
        encoder_latent_dim: int = 512,
        decoder_num_channels: int = 1024,
        decoder_scan_chunk_size: int | None = None,
        encoder_scan_chunk_size: int | None = None,
        dtype=torch.float32,
        fused_attention: bool = False,
        quantize: bool = False,
        residual_dtype=torch.float32,
        fused_block: bool = False,
        num_heads: int = 8,
        qkv_size: int = 64 * 8,
        input_track_layers: int = 2,
        input_track_mlp: int = 1024,
        tracks_to_latents_layers: int = 6,
        tracks_to_latents_mlp: int = 2048,
        decompress_layers: int = 3,
        decompress_mlp: int = 2048,
        readout_layers: int = 4,
        readout_mlp: int = 1024,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_output_frames = num_output_frames
        self.num_frequencies = num_frequencies
        self.track_scale_factor = track_scale_factor
        self.time_scale_factor = time_scale_factor
        self.decoder_scan_chunk_size = decoder_scan_chunk_size
        self.encoder_scan_chunk_size = encoder_scan_chunk_size
        self.dtype, self.residual_dtype = dtype, residual_dtype

        two_f = 2 * num_frequencies
        stack = dict(qkv_size=qkv_size, num_heads=num_heads, dtype=dtype,
                     use_fused=fused_attention, residual_dtype=residual_dtype,
                     quantize=quantize, fused_block=fused_block, device=device)
        self.initializer = ParamStateInit((num_latent_tokens, encoder_latent_dim), device)
        # (x, y, t/T) embedded per coordinate.
        self.track_token_projection = Dense(3 * two_f, track_token_dim, dtype, device)
        self.compressor = Dense(encoder_latent_dim, latent_token_dim, dtype, device)
        self.decompressor = Dense(latent_token_dim, decoder_num_channels - 128, dtype, device)
        self.input_track_transformer = TransformerStack(
            track_token_dim, mlp_size=input_track_mlp, num_layers=input_track_layers, **stack
        )
        self.tracks_to_latents = TransformerStack(
            encoder_latent_dim, mlp_size=tracks_to_latents_mlp,
            num_layers=tracks_to_latents_layers, kv_width=track_token_dim, **stack
        )
        self.decompress_attn = TransformerStack(
            decoder_num_channels - 128, mlp_size=decompress_mlp,
            num_layers=decompress_layers, **stack
        )
        self.track_readout_attn = TransformerStack(
            decoder_num_channels, mlp_size=readout_mlp, num_layers=readout_layers, **stack
        )
        # The decoder embeds (embedded (x, y), frame term) a second time.
        self.query_encoder = Dense((2 * two_f + 1) * two_f, decoder_num_channels, dtype, device)
        self.track_predictor = Dense(decoder_num_channels, num_output_frames * 4, dtype, device)
        reset_parameters(self, torch.Generator(device=device).manual_seed(seed))

    # ------------------------------------------------------------------ #
    # Encoder
    # ------------------------------------------------------------------ #

    def encode_point_identities(self, query_points):  # [*B Q 2] -> [*B Q 4F]
        return sinusoidal_embedding(query_points / self.track_scale_factor, self.num_frequencies)

    def embed_track_pos_visible(self, tracks, visible):
        """[*B N T 2] -> [*B N T 6F]: sinusoid of (x, y, t/T)."""
        num_frames = tracks.shape[-2]
        fr_id = torch.arange(num_frames, device=tracks.device, dtype=torch.float32) / num_frames
        fr_id = fr_id[None, None, :, None].expand(visible.shape)
        tracks = torch.cat([tracks, fr_id], dim=-1)
        return sinusoidal_embedding(tracks / self.track_scale_factor, self.num_frequencies)

    def encode_tracks(self, tracks, visible, restart):
        """Per-track temporal transformer + visibility-weighted mean pooling;
        invisible keys and keys at or past ``restart`` are masked."""
        track_tokens = self.track_token_projection(self.embed_track_pos_visible(tracks, visible))
        mask = track_temporal_mask(visible, restart)
        track_tokens = self.input_track_transformer(track_tokens, qq_mask=mask)
        vis = visible[..., 0].bool()[..., None].float()
        return (track_tokens * vis).sum(-2) / torch.clamp(vis.sum(-2), min=1.0)

    def encode(self, inputs, gather_tokens=None) -> torch.Tensor:  # -> float['B 128 64']
        """Latents of the support tracks; ``gather_tokens`` (a sharded
        caller's) maps this rank's track tokens [B N D] to every rank's."""
        tracks = inputs["support_tracks"]
        visible = inputs["support_tracks_visible"]
        restart = inputs["boundary_frame"]
        h = self.encoder_scan_chunk_size
        if h is None:
            support_track_tokens = self.encode_tracks(tracks, visible, restart)
        else:
            if tracks.shape[-3] % h:
                raise ValueError(
                    f"encoder_scan_chunk_size={h} must divide the support "
                    f"track count {tracks.shape[-3]}"
                )
            support_track_tokens = torch.cat([
                remat(self.encode_tracks, tracks[..., i : i + h, :, :],
                      visible[..., i : i + h, :, :], restart)
                for i in range(0, tracks.shape[-3], h)
            ], dim=-2)
        if gather_tokens is not None:
            support_track_tokens = gather_tokens(support_track_tokens)
        latents = self.initializer((tracks.shape[0],))
        latents = self.tracks_to_latents(latents, support_track_tokens)
        # Latents leave in f32 whatever the compute dtype (1/128 grid).
        return self.compressor(latents).float()

    # ------------------------------------------------------------------ #
    # Decoder
    # ------------------------------------------------------------------ #

    def get_decoder_context(self, inputs) -> TrackAutoEncoderDecoderContext:
        """Split query (t | x, y), sinusoid-embed identities; default 32x32 grid."""
        if "query_points" in inputs:
            decoder_query = inputs["query_points"][..., 1:]
            query_frame = torch.round(inputs["query_points"][..., 0]).to(torch.int32)
        else:
            decoder_query = default_query_grid(
                inputs["support_tracks"].shape[:-3], num_coords=2,
                device=inputs["support_tracks"].device,
            )
            query_frame = torch.zeros(decoder_query.shape[:-1], dtype=torch.int32,
                                      device=decoder_query.device)
        return TrackAutoEncoderDecoderContext(
            decoder_query=self.encode_point_identities(decoder_query),
            query_frame=query_frame,
            boundary_frame=inputs["boundary_frame"],
        )

    def decode(self, latents, decoder_context, discretize: bool = True,
               dither_rows=None) -> TrackAutoEncoderResults:
        latents = (quantize_latents(latents, dither_rows=dither_rows) if discretize
                   else latents.clamp(-1.0, 1.0))
        latents = self.decompress_attn(self.decompressor(latents))

        queries = torch.cat([
            decoder_context.decoder_query,
            # Float floor division: 0 for every frame < 150 (preserved quirk).
            decoder_context.query_frame[..., None] // self.time_scale_factor,
        ], dim=-1)
        query_tokens = self.query_encoder(
            sinusoidal_embedding(queries / self.track_scale_factor, self.num_frequencies)
        )
        num_queries = query_tokens.shape[-2]
        latents = latents[..., None, :, :].expand(
            latents.shape[:-2] + (num_queries,) + latents.shape[-2:]
        )
        latents = append_time_feature(latents, decoder_context.query_frame)
        tokens = torch.cat([query_tokens[..., None, :], latents], dim=-2)  # promotes
        out = self.track_predictor(self.track_readout_attn(tokens)[..., 0, :]).float()

        t = self.num_output_frames
        return TrackAutoEncoderResults(
            tracks=torch.stack([out[..., :t], out[..., t : 2 * t]], dim=-1),
            visible_logits=out[..., 2 * t : 3 * t, None],
            certain_logits=out[..., 3 * t :, None],
        )

    def forward(self, inputs, gather_tokens=None, dither_rows=None) -> TrackAutoEncoderResults:
        """Encode and decode ``inputs``. The sharded paths (``parallel/``) pass
        ``gather_tokens`` and ``dither_rows`` (see ``encode``,
        ``quantize_latents``)."""
        return chunked_decode(self, self.encode(inputs, gather_tokens), inputs, dither_rows)
