"""Plain reference of the two track autoencoders (3DSPA's
``TrackAutoEncoder3D`` and TRAJAN's ``TrackAutoEncoder``), written from their
published equations as plain float32 PyTorch over a dict of weights.

The weights are named as the program's parameters are (the flax tree's
names), so that the benchmark makes one dict from the seed and hands the same
to the program (``load_state_dict``) and to this reference.

The function, per model:

* Encoder: each support track's frames embedded as sinusoids of (x, y[, z],
  t/T) over the frequencies ``2**(i/3)`` (sin, then cos as sin(x + pi/2)),
  projected to the track width; 3DSPA adds projections of the DINO and depth
  features and prepends a readout token. A stack of parallel pre-LN blocks
  (one LayerNorm before self-attention, QK-RMSNorm heads, GELU(tanh) MLP after
  a second LayerNorm, final LayerNorm) attends over each track's frames, keys
  masked where the track is invisible or at or past the boundary frame.
  3DSPA keeps the readout token's output; TRAJAN the visibility-weighted mean
  of the frame tokens (over max(1, sum of visibility)).
* Latents: 128 learned tokens, a stack whose blocks add cross-attention to the
  track tokens, then a projection to the latent width.
* Bottleneck: clip to [-1, 1], round to a 1/128 grid, add the fixed dither
  ``uniform(PRNGKey(0), shape) / 128 - 1/256`` (straight-through gradient).
* Decoder: a projection and a stack over the latents; each query point's
  sinusoid (and a frame term, ``t // 150`` in float, 0 for every frame below
  150) embedded a second time and projected; each query attends to the
  latents with 128 time-shifted channels appended (channel d = latent channel
  5t + d where in range, else 0) and its own token is read out to the tracks
  and logits of every frame.

``Precision`` decides what the matrix products round to: f32 is the
reference, lower modes the controls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import prng
from benchmark.reference.precision import Precision

NORM_EPS = 1e-6
FILL = torch.finfo(torch.float32).min


def is_3d(cfg: dict) -> bool:
    return cfg["architecture"] == "TrackAutoEncoder3D"


def _stacks(cfg: dict) -> dict:
    """name -> (width, mlp, layers, kv width or None)."""
    dec = cfg["decoder_num_channels"]
    return {
        "input_track_transformer": (cfg["track_token_dim"], cfg["input_track_mlp"],
                                    cfg["input_track_layers"], None),
        "tracks_to_latents": (cfg["encoder_latent_dim"], cfg["tracks_to_latents_mlp"],
                              cfg["tracks_to_latents_layers"], cfg["track_token_dim"]),
        "decompress_attn": (dec - 128, cfg["decompress_mlp"], cfg["decompress_layers"], None),
        "track_readout_attn": (dec, cfg["readout_mlp"], cfg["readout_layers"], None),
    }


def param_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str, int]]:
    """name -> (shape, law, fan_in) of every weight, in the program's order.

    Laws: ``kernel`` normal with variance 1/fan_in; ``bias`` and ``scale``
    small normal perturbations of 0 and 1; ``state`` standard normal.
    """
    two_f = 2 * cfg["num_frequencies"]
    heads, qkv = cfg["num_heads"], cfg["qkv_size"]
    head = qkv // heads
    dec = cfg["decoder_num_channels"]
    coords = 3 if is_3d(cfg) else 2
    out: dict = {}

    def dense(name, n_in, n_out):
        out[f"{name}.kernel"] = ((n_in, n_out), "kernel", n_in)
        out[f"{name}.bias"] = ((n_out,), "bias", 0)

    out["initializer.state_init"] = ((cfg["num_latent_tokens"], cfg["encoder_latent_dim"]),
                                     "state", 0)
    dense("track_token_projection", (coords + 1) * two_f, cfg["track_token_dim"])
    if is_3d(cfg):
        if cfg["use_dino"]:
            dense("dino_projection", cfg["dino_feature_dim"], cfg["track_token_dim"])
        if cfg["use_depth"]:
            dense("depth_projection", cfg["depth_feature_dim"], cfg["track_token_dim"])
    dense("compressor", cfg["encoder_latent_dim"], cfg["latent_token_dim"])
    dense("decompressor", cfg["latent_token_dim"], dec - 128)
    if is_3d(cfg):
        out["input_readout_token.state_init"] = ((1, cfg["track_token_dim"]), "state", 0)
    for stack, (width, mlp, layers, kv_width) in _stacks(cfg).items():
        for i in range(layers):
            p = f"{stack}.layer_{i}"
            out[f"{p}.norm_q.scale"] = ((width,), "scale", 0)
            atts = ["self_att"] + (["cross_att"] if kv_width else [])
            for att in atts:
                kv = width if att == "self_att" else kv_width
                a = f"{p}.{att}"
                out[f"{a}.dense_query.kernel"] = ((width, heads, head), "kernel", width)
                out[f"{a}.dense_key.kernel"] = ((kv, heads, head), "kernel", kv)
                out[f"{a}.norm_query.scale"] = ((head,), "scale", 0)
                out[f"{a}.norm_key.scale"] = ((head,), "scale", 0)
                out[f"{a}.dense_value.kernel"] = ((kv, heads, head), "kernel", kv)
                out[f"{a}.dense_out.kernel"] = ((heads, head, width), "kernel", qkv)
                out[f"{a}.dense_out.bias"] = ((width,), "bias", 0)
            out[f"{p}.norm_attn.scale"] = ((width,), "scale", 0)
            dense(f"{p}.MLP_in", width, mlp)
            dense(f"{p}.MLP_out", mlp, width)
        out[f"{stack}.norm_encoder.scale"] = ((width,), "scale", 0)
    dense("query_encoder", (coords * two_f + 1) * two_f, dec)
    dense("track_predictor", dec, cfg["num_output_frames"] * 4)
    return out


def sinusoid(x: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    """[..., C] -> [..., C * 2F]: per coordinate F sines, then F cosines."""
    scales = torch.tensor([2 ** (i / 3) for i in range(num_frequencies)],
                          dtype=torch.float32, device=x.device)
    y = x.float()[..., None] * scales
    return torch.sin(torch.cat([y, y + 0.5 * math.pi], dim=-1)).flatten(-2)


class Model:
    """The reference forward over ``weights`` (name -> f32 tensor)."""

    def __init__(self, cfg: dict, weights: dict, precision: Precision | None = None,
                 chunk: int | None = None):
        self.cfg, self.w = cfg, weights
        self.p = precision or Precision("f32")
        # Tracks or queries per block of the encoder and the decoder: memory
        # only; recomputed in the backward pass where autograd records.
        self.chunk = chunk

    # -- layers -----------------------------------------------------------
    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        kernel = self.w[f"{name}.kernel"]
        y = self.p.mm(x, kernel.reshape(kernel.shape[0], -1))
        bias = self.w.get(f"{name}.bias")
        return y if bias is None else y + bias

    def layer_norm(self, name: str, x: torch.Tensor, centered: bool = True) -> torch.Tensor:
        mean2 = (x * x).mean(-1, keepdim=True)
        if centered:
            mean = x.mean(-1, keepdim=True)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            x = x - mean
        else:
            var = mean2
        return x * torch.rsqrt(var + NORM_EPS) * self.w[f"{name}.scale"]

    def attention(self, name: str, xq, xkv, key_mask=None) -> torch.Tensor:
        """QK-RMSNorm multi-head attention; key_mask [..., K] (True = attend)."""
        heads = self.cfg["num_heads"]
        head = self.cfg["qkv_size"] // heads

        def proj(key, x):
            return self.dense(f"{name}.{key}", x).unflatten(-1, (heads, head))

        q = self.layer_norm(f"{name}.norm_query", proj("dense_query", xq), centered=False)
        k = self.layer_norm(f"{name}.norm_key", proj("dense_key", xkv), centered=False)
        v = proj("dense_value", xkv)
        logits = self.p.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(head)
        if key_mask is not None:
            logits = torch.where(key_mask[..., None, None, :], logits, FILL)
        probs = torch.softmax(logits, dim=-1)
        x = self.p.einsum("...hqk,...khd->...qhd", probs, v)
        kernel = self.w[f"{name}.dense_out.kernel"]
        return self.p.mm(x.flatten(-2), kernel.reshape(-1, kernel.shape[-1])) + \
            self.w[f"{name}.dense_out.bias"]

    def stack(self, name: str, x, kv=None, key_mask=None) -> torch.Tensor:
        layers = _stacks(self.cfg)[name][2]
        for i in range(layers):
            p = f"{name}.layer_{i}"
            normed = self.layer_norm(f"{p}.norm_q", x)
            h = x + self.attention(f"{p}.self_att", normed, normed, key_mask)
            if kv is not None:
                h = h + self.attention(f"{p}.cross_att", normed, kv)
            m = F.gelu(self.dense(f"{p}.MLP_in", self.layer_norm(f"{p}.norm_attn", h)),
                       approximate="tanh")
            x = h + self.dense(f"{p}.MLP_out", m)
        return self.layer_norm(f"{name}.norm_encoder", x)

    # -- encoder ----------------------------------------------------------
    def _in_blocks(self, fn, *tensors):
        """``fn`` over blocks of ``self.chunk`` rows of axis 1 (tracks or
        queries) of each tensor (``None`` passes through), the outputs
        concatenated along axis 1; each block recomputed in the backward
        pass where autograd records."""
        n = tensors[0].shape[1]
        if self.chunk is None or self.chunk >= n:
            return fn(*tensors)
        outs = []
        for i in range(0, n, self.chunk):
            block = [None if t is None else t[:, i : i + self.chunk] for t in tensors]
            outs.append(checkpoint(fn, *block, use_reentrant=False)
                        if torch.is_grad_enabled() else fn(*block))
        return torch.cat(outs, dim=1)

    def encode_tracks(self, tracks, visible, boundary, dino=None, depth=None):
        cfg = self.cfg
        frames = tracks.shape[-2]
        t = (torch.arange(frames, device=tracks.device, dtype=torch.float32) / frames)
        t = t[:, None].expand(visible.shape)
        emb = sinusoid(torch.cat([tracks, t], dim=-1) / cfg["track_scale_factor"],
                       cfg["num_frequencies"])
        x = self.dense("track_token_projection", emb)
        in_time = torch.arange(frames, device=tracks.device) < boundary[:, None, None]
        keys = visible[..., 0].bool() & in_time  # [B N T]
        if is_3d(cfg):
            if dino is not None:
                x = x + self.dense("dino_projection", dino)
            if depth is not None:
                x = x + self.dense("depth_projection", depth)
            token = self.w["input_readout_token.state_init"].expand(x.shape[:-2] + (1, x.shape[-1]))
            x = torch.cat([token, x], dim=-2)
            keys = torch.cat([torch.ones_like(keys[..., :1]), keys], dim=-1)
            return self.stack("input_track_transformer", x, key_mask=keys)[..., 0, :]
        x = self.stack("input_track_transformer", x, key_mask=keys)
        vis = visible[..., 0].bool().float()[..., None]
        return (x * vis).sum(-2) / torch.clamp(vis.sum(-2), min=1.0)

    def encode(self, batch: dict) -> torch.Tensor:
        tracks = batch["support_tracks"]
        tokens = self._in_blocks(
            lambda tr, vi, di, de: self.encode_tracks(tr, vi, batch["boundary_frame"], di, de),
            tracks, batch["support_tracks_visible"],
            batch.get("dino_features") if is_3d(self.cfg) else None,
            batch.get("depth_features") if is_3d(self.cfg) else None)
        latents = self.w["initializer.state_init"].expand((tracks.shape[0],) +
                                                          self.w["initializer.state_init"].shape)
        latents = self.stack("tracks_to_latents", latents, kv=tokens)
        return self.dense("compressor", latents)

    # -- decoder ----------------------------------------------------------
    def bottleneck(self, latents: torch.Tensor, levels: float = 128.0) -> torch.Tensor:
        latents = latents.clamp(-1.0, 1.0)
        disc = torch.round(latents * levels) / levels
        noise = torch.from_numpy(prng.uniform(tuple(latents.shape))).to(latents.device)
        disc = disc + noise / levels - 1.0 / (2 * levels)
        return latents - (latents - disc).detach()

    def readout(self, latents, query_points):
        """latents [B 128 C], query_points [B Q 1+coords] -> out [B Q 4T]."""
        cfg = self.cfg
        nf = cfg["num_frequencies"]
        frame = torch.round(query_points[..., 0])
        ident = sinusoid(query_points[..., 1:] / cfg["track_scale_factor"], nf)
        queries = torch.cat([ident, torch.floor(frame / cfg["time_scale_factor"])[..., None]],
                            dim=-1)
        qtok = self.dense("query_encoder", sinusoid(queries / cfg["track_scale_factor"], nf))
        b, q = query_points.shape[:2]
        lat = latents[:, None].expand(b, q, *latents.shape[1:])
        channels = lat.shape[-1]
        idx = (frame.long() * 5)[..., None, None] + torch.arange(128, device=lat.device)
        shifted = torch.gather(lat, -1, idx.clamp(0, channels - 1).expand(b, q, lat.shape[2], 128))
        shifted = torch.where(idx < channels, shifted, torch.zeros((), device=lat.device))
        tokens = torch.cat([qtok[..., None, :], torch.cat([lat, shifted], dim=-1)], dim=-2)
        return self.dense("track_predictor", self.stack("track_readout_attn", tokens)[..., 0, :])

    def decode(self, latents, batch) -> dict:
        latents = self.stack("decompress_attn", self.dense("decompressor", self.bottleneck(latents)))
        out = self._in_blocks(lambda qp: self.readout(latents, qp), batch["query_points"])
        t = self.cfg["num_output_frames"]
        if is_3d(self.cfg):
            tracks = torch.stack([out[..., :t], out[..., t:2 * t], out[..., 2 * t:3 * t]], -1)
            return {"tracks": tracks, "visible_logits": out[..., 3 * t:, None]}
        return {"tracks": torch.stack([out[..., :t], out[..., t:2 * t]], -1),
                "visible_logits": out[..., 2 * t:3 * t, None],
                "certain_logits": out[..., 3 * t:, None]}

    def __call__(self, batch: dict) -> dict:
        return self.decode(self.encode(batch), batch)


def loss(cfg: dict, predictions: dict, batch: dict, l1_weight: float = 5000.0,
         bce_weight: float = 1e-8) -> torch.Tensor:
    """Visibility-masked L1 on positions + BCE on visibility, both over the
    clamped visible mass max(1, sum of visibility)."""
    vis = batch["query_tracks_visible"].float()
    denom = torch.clamp(vis.sum(), min=1.0)
    position = ((predictions["tracks"] - batch["query_tracks"]).abs() * vis).sum() / denom
    logits = predictions["visible_logits"]
    bce = (-vis * F.logsigmoid(logits) - (1.0 - vis) * F.logsigmoid(-logits)).sum() / denom
    return l1_weight * position + bce_weight * bce
