"""3DSPA: the 3D semantic point-track autoencoder (port of
``tdspa/models/spa3d.py``).

Extends TRAJAN to (x, y, z) tracks, adds residual DINOv2 (768-d) and depth
(256-d) projections into the track tokens, and pools each track's frame
tokens through a learnable readout token. Attribute names follow the flax
parameter tree, so ``tdspa_torch.infer.convert`` maps it by name.

Kept from the JAX package: the 768->384 and 256->384 feature projections
(the reference's square ones cannot be added to the tokens), the dead
decoder time term ``query_frame // time_scale_factor``, the fixed-key
dither, ``certain_logits`` of zeros, and the key-only readout mask.
``encoder_scan_chunk_size`` / ``decoder_scan_chunk_size`` become plain loops
over support-track / query chunks; chunked output equals unchunked output.
Where JAX rematerialises (each encoder chunk, ``get_decoder_context`` and
``decode``), the port recomputes under ``torch.utils.checkpoint`` while
autograd records, so a full-width training step fits in memory.
"""

from __future__ import annotations

import torch
from torch import nn

from tdspa_torch.core.attention import Dense, TransformerStack, reset_parameters
from tdspa_torch.core.embeddings import ParamStateInit, sinusoidal_embedding
from tdspa_torch.core.masks import readout_temporal_mask
from tdspa_torch.models.containers import (
    TrackAutoEncoderDecoderContext,
    TrackAutoEncoderResults,
)
from tdspa_torch.models.trajan2d import (
    append_time_feature,
    chunked_decode,
    default_query_grid,
    quantize_latents,
    remat,
)
from tdspa_torch.utils.device import resolve_device


class TrackAutoEncoder3D(nn.Module):
    """3DSPA 3D track autoencoder (~94M params at defaults).

    Parameters are created on ``device`` (GPU unless ``device="cpu"``) and
    initialised from ``torch.Generator(device).manual_seed(seed)`` with the
    flax initialisers' laws; load trained weights with
    ``tdspa_torch.infer.checkpoint``. Two inference knobs of the JAX model,
    off by default, share the parameters: ``quantize`` runs every stack's
    projections and MLPs through dynamic int8 (``csrc/quant_matmul.cu``);
    ``fused_block`` runs each unmasked self-attention block (the decompress
    and readout stacks) through the fused block kernel (``csrc/block.cu``).
    """

    def __init__(
        self,
        num_output_frames: int = 150,
        num_latent_tokens: int = 128,
        latent_token_dim: int = 96,
        num_frequencies: int = 32,
        track_scale_factor: float = 1.0,
        time_scale_factor: float = 150.0,
        track_token_dim: int = 384,
        encoder_latent_dim: int = 512,
        decoder_num_channels: int = 1280,
        dino_feature_dim: int = 768,
        depth_feature_dim: int = 256,
        use_dino: bool = True,
        use_depth: bool = True,
        decoder_scan_chunk_size: int | None = None,
        encoder_scan_chunk_size: int | None = None,
        dtype=torch.float32,
        fused_attention: bool = False,
        quantize: bool = False,
        residual_dtype=torch.float32,
        fused_block: bool = False,
        num_heads: int = 8,
        qkv_size: int = 96 * 8,
        input_track_layers: int = 3,
        input_track_mlp: int = 1536,
        tracks_to_latents_layers: int = 4,
        tracks_to_latents_mlp: int = 2048,
        decompress_layers: int = 4,
        decompress_mlp: int = 2048,
        readout_layers: int = 4,
        readout_mlp: int = 1536,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_output_frames = num_output_frames
        self.num_frequencies = num_frequencies
        self.track_scale_factor = track_scale_factor
        self.time_scale_factor = time_scale_factor
        self.track_token_dim = track_token_dim
        self.use_dino, self.use_depth = use_dino, use_depth
        self.decoder_scan_chunk_size = decoder_scan_chunk_size
        self.encoder_scan_chunk_size = encoder_scan_chunk_size
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.quantize, self.fused_block = quantize, fused_block

        two_f = 2 * num_frequencies
        stack = dict(qkv_size=qkv_size, num_heads=num_heads, dtype=dtype,
                     use_fused=fused_attention, residual_dtype=residual_dtype,
                     quantize=quantize, fused_block=fused_block, device=device)
        self.initializer = ParamStateInit((num_latent_tokens, encoder_latent_dim), device)
        # (x, y, z, t/T) embedded per coordinate.
        self.track_token_projection = Dense(4 * two_f, track_token_dim, dtype, device)
        if use_dino:
            self.dino_projection = Dense(dino_feature_dim, track_token_dim, dtype, device)
        if use_depth:
            self.depth_projection = Dense(depth_feature_dim, track_token_dim, dtype, device)
        self.compressor = Dense(encoder_latent_dim, latent_token_dim, dtype, device)
        self.decompressor = Dense(latent_token_dim, decoder_num_channels - 128, dtype, device)
        self.input_readout_token = ParamStateInit((1, track_token_dim), device)
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
        # The decoder embeds (embedded (x, y, z), frame term) a second time.
        self.query_encoder = Dense((3 * two_f + 1) * two_f, decoder_num_channels, dtype, device)
        self.track_predictor = Dense(decoder_num_channels, num_output_frames * 4, dtype, device)
        reset_parameters(self, torch.Generator(device=device).manual_seed(seed))

    # ------------------------------------------------------------------ #
    # Encoder
    # ------------------------------------------------------------------ #

    def encode_point_identities(self, query_points):  # [*B Q 3] -> [*B Q 6F]
        return sinusoidal_embedding(query_points / self.track_scale_factor, self.num_frequencies)

    def embed_track_pos_visible(self, tracks, visible, dino_features=None, depth_features=None):
        """[*B N T 3] -> [*B N T track_token_dim] with residual feature adds."""
        num_frames = tracks.shape[-2]
        fr_id = torch.arange(num_frames, device=tracks.device, dtype=torch.float32) / num_frames
        fr_id = fr_id[None, None, :, None].expand(visible.shape)
        tracks_with_time = torch.cat([tracks, fr_id], dim=-1)
        track_embeddings = self.track_token_projection(
            sinusoidal_embedding(tracks_with_time / self.track_scale_factor, self.num_frequencies)
        )
        if self.use_dino and dino_features is not None:
            track_embeddings = track_embeddings + self.dino_projection(dino_features)
        if self.use_depth and depth_features is not None:
            track_embeddings = track_embeddings + self.depth_projection(depth_features)
        return track_embeddings

    def encode_tracks(self, tracks, visible, restart, dino_features=None, depth_features=None):
        """Per-track temporal transformer; the readout token's slot is the summary."""
        track_embeddings = self.embed_track_pos_visible(
            tracks, visible, dino_features=dino_features, depth_features=depth_features
        )
        readout_token = self.input_readout_token(track_embeddings.shape[:-2])
        track_tokens = torch.cat([readout_token, track_embeddings], dim=-2)  # promotes
        mask = readout_temporal_mask(visible, restart)
        track_tokens = self.input_track_transformer(track_tokens, qq_mask=mask)
        return track_tokens[..., 0, :]

    def encode(self, inputs, gather_tokens=None) -> torch.Tensor:  # -> float['B 128 96']
        """Latents of the support tracks; ``gather_tokens`` (a sharded
        caller's) maps this rank's track tokens [B N D] to every rank's."""
        tracks = inputs["support_tracks"]
        visible = inputs["support_tracks_visible"]
        dino, depth = inputs.get("dino_features"), inputs.get("depth_features")
        h = self.encoder_scan_chunk_size
        if h is None:
            support_track_tokens = self.encode_tracks(
                tracks, visible, inputs["boundary_frame"], dino_features=dino,
                depth_features=depth,
            )
        else:
            if tracks.shape[-3] % h:
                raise ValueError(
                    f"encoder_scan_chunk_size={h} must divide the support "
                    f"track count {tracks.shape[-3]}"
                )

            def part(x, i):  # the support-track axis is -3
                return None if x is None else x[..., i : i + h, :, :]

            # Each chunk is recomputed in the backward pass (JAX's nn.remat).
            support_track_tokens = torch.cat([
                remat(self.encode_tracks, part(tracks, i), part(visible, i),
                      inputs["boundary_frame"], part(dino, i), part(depth, i))
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
        if "query_points" in inputs:
            decoder_query = inputs["query_points"][..., 1:]  # (x, y, z)
            query_frame = torch.round(inputs["query_points"][..., 0]).to(torch.int32)
        else:
            decoder_query = default_query_grid(
                inputs["support_tracks"].shape[:-3], num_coords=3,
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
        tracks = torch.stack([out[..., :t], out[..., t : 2 * t], out[..., 2 * t : 3 * t]], dim=-1)
        visible_logits = out[..., 3 * t :, None]
        return TrackAutoEncoderResults(
            tracks=tracks,
            visible_logits=visible_logits,
            # 3DSPA only predicts visibility; certainty is zeros.
            certain_logits=torch.zeros_like(visible_logits),
        )

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #

    def forward(self, inputs, gather_tokens=None, dither_rows=None) -> TrackAutoEncoderResults:
        """Encode and decode ``inputs``. The sharded paths (``parallel/``) pass
        ``gather_tokens`` and ``dither_rows`` (see ``encode``,
        ``quantize_latents``)."""
        return chunked_decode(self, self.encode(inputs, gather_tokens), inputs, dither_rows)
