"""Video depth estimation (port of ``tdspa/features/depth.py``).

* ``VideoDepthEstimator``: the DINOv2 encoder (``features/vit.py``, its
  attention in the Hopper ViT kernel on a GPU) tapped at four layers, and a
  DPT decode head (projection -> multi-scale reassembly -> residual fusion
  -> depth head) with one of two temporal heads:
  - ``use_temporal``: the JAX package's from-scratch temporal attention on
    the coarsest fused map. Frames run in disjoint groups of
    ``frame_chunk``; the last group is padded by repeating the last frame,
    because padded frames take part in temporal attention.
  - ``use_motion_modules``: Video Depth Anything's temporal head
    (``dpt_temporal.py::DPTHeadTemporal``): four AnimateDiff motion modules,
    on the projected layers 3 and 4 (``out_channels[2]``, ``[3]`` wide)
    and after the two coarsest fusions (``features`` wide), and VDA's video
    schedule (``video_depth.py::infer_video_depth``, ``vda_windows``):
    overlapping windows of 32 frames whose first 10 inputs are keyframes of
    the window before. VDA's cross-window scale-and-shift alignment is not
    run: each window gives its new frames as the network computes them.
  ``vda_model`` gives the arguments of a released VDA model by name.
* ``depth_window``: one group or window through the backbone and head; it
  counts ``depth_window.windows`` and ``depth_window.frame_passes``.
* ``convert_vda_params`` / ``motion_module_structure``: a released
  ``video_depth_anything_*.pth`` state_dict -> the flax parameter tree
  (numpy), which ``from_checkpoint`` loads.
* ``ConstantDepthProvider``: unit depth (the reference's z = 1 fallback).

Spans, inside the pipeline's ``tdspa.video.depth``: ``tdspa.depth.window``
(each group or window) holds ``tdspa.depth.backbone`` (the ViT's
``tdspa.vit.*`` spans and the taps' norms), ``tdspa.depth.reassemble``
(projections, resize layers, ``scratch_*``), ``tdspa.depth.motion`` (each
motion module, or ``temporal_3``), ``tdspa.depth.fusion`` and
``tdspa.depth.output`` (``head_conv*`` and the resizes).

Parameter names and layouts are the flax tree's, so a JAX parameter tree
loads through ``params_from_flax``. Every matrix product and convolution is
``torch.matmul`` / ``F.conv2d`` / ``F.conv_transpose2d``, as the JAX package
leaves them to XLA. The external-repository adapter ``TorchVDAProvider`` is
not ported (ROADMAP.md).
"""

from __future__ import annotations

import logging
import math
import re
from typing import Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from tdspa_torch.core.attention import Dense, DenseGeneral
from tdspa_torch.core.layers import Conv, ConvTranspose, GroupNorm, LayerNorm, init_parameters
from tdspa_torch.features.dino import normalize_frames
from tdspa_torch.features.vit import Dinov2, ViTConfig
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.ops.resize import resize, resize_align_corners
from tdspa_torch.utils.device import resolve_device
from tdspa_torch.utils.profiling import span

logger = logging.getLogger(__name__)

VDA_MODEL_CONFIGS = {
    "vits": {"encoder": "vits", "features": 64, "out_channels": [48, 96, 192, 384],
             "layer_idxs": [2, 5, 8, 11]},
    "vitb": {"encoder": "vitb", "features": 128, "out_channels": [96, 192, 384, 768],
             "layer_idxs": [2, 5, 8, 11]},
    "vitl": {"encoder": "vitl", "features": 256,
             "out_channels": [256, 512, 1024, 1024], "layer_idxs": [4, 11, 17, 23]},
}
# Released Video Depth Anything models and their encoders.
VDA_MODELS = {
    "depth-anything/Video-Depth-Anything-Large": "vitl",
}
# VDA's video schedule (video_depth.py: INFER_LEN, OVERLAP, KEYFRAMES).
VDA_WINDOW, VDA_OVERLAP = 32, 10
VDA_KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)


def vda_model(name: str) -> dict:
    """``VideoDepthEstimator``'s arguments for a released Video Depth
    Anything model (``VDA_MODELS``): its encoder, and VDA's temporal head in
    place of the from-scratch one. ``ValueError`` for another name."""
    if name not in VDA_MODELS:
        raise ValueError(f"unknown Video Depth Anything model {name!r}: one of "
                         f"{sorted(VDA_MODELS)}")
    return {"encoder": VDA_MODELS[name], "use_temporal": False, "use_motion_modules": True}


def vda_windows(num_frames: int) -> list[tuple[list[int], int]]:
    """VDA's windows over ``num_frames`` frames: (input frame indices, the
    position of the window's first new frame) for each.

    Window 0 reads frames 0 .. 31 and gives them all. Window k reads the
    previous window's inputs at ``VDA_KEYFRAMES``, then frames 22k + 10 ..
    22k + 31, and gives those. Frames past the end are copies of the last,
    as VDA pads the video. Windows run until every frame is given: VDA runs
    ceil(T / 22), and a last one whose new frames are all padding changes
    nothing without its alignment, so it is not run (150 frames: 7 either
    way). The window is the motion modules' 32 positions.
    """
    last, stride = num_frames - 1, VDA_WINDOW - VDA_OVERLAP
    inputs = [min(i, last) for i in range(VDA_WINDOW)]
    out = [(inputs, 0)]
    while (len(out) - 1) * stride + VDA_WINDOW < num_frames:
        start = len(out) * stride
        inputs = [inputs[k] for k in VDA_KEYFRAMES] + [
            min(start + i, last) for i in range(VDA_OVERLAP, VDA_WINDOW)]
        out.append((inputs, VDA_OVERLAP))
    return out


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype, device):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dtype, device=device)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FusionBlock(nn.Module):
    def __init__(self, features: int, has_skip: bool, dtype, device):
        super().__init__()
        if has_skip:
            self.rcu1 = _ResidualConvUnit(features, dtype, device)
        self.rcu2 = _ResidualConvUnit(features, dtype, device)
        self.project = Conv(features, features, 1, dtype=dtype, device=device)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        _, h, w, _ = x.shape
        x = resize_align_corners(x, out_hw if out_hw is not None else (h * 2, w * 2))
        return self.project(x)


def _sinusoidal_pe(length: int, dim: int, dtype=torch.float32, device="cpu"):
    """AnimateDiff PositionalEncoding buffer: interleaved sin/cos."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe.to(dtype)


class _TemporalSelfAttention(nn.Module):
    """AnimateDiff VersatileAttention (Temporal_Self): bias-free q/k/v,
    sinusoidal positional encoding on the frame axis, to_out projection."""

    def __init__(self, channels: int, num_heads: int, dtype, device):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, DenseGeneral((channels,), (channels,), False, dtype, device))
        self.to_out = Dense(channels, channels, dtype, device)

    def forward(self, tokens):  # [S, T, C]: T is the sequence axis
        s, t, c = tokens.shape
        hd = c // self.num_heads
        x = tokens + _sinusoidal_pe(t, c, tokens.dtype, tokens.device)[None]

        def heads(a):
            return a.reshape(s, t, self.num_heads, hd)

        # As in JAX, dividing by a NumPy scalar promotes q to f32.
        q = heads(self.to_q(x)).float() / math.sqrt(hd)
        logits = torch.einsum("sqhd,skhd->shqk", q, heads(self.to_k(x)).float())
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("shqk,skhd->sqhd", probs.float(), heads(self.to_v(x)).float())
        return self.to_out(out.reshape(s, t, c).to(self.dtype))


class _GEGLUFeedForward(nn.Module):
    """diffusers FeedForward(GEGLU): proj -> chunk2 -> x * gelu(gate) -> out."""

    def __init__(self, channels: int, dtype, device, mult: int = 4):
        super().__init__()
        self.geglu_proj = Dense(channels, channels * mult * 2, dtype, device)
        self.out = Dense(channels * mult, channels, dtype, device)

    def forward(self, x):
        h, gate = self.geglu_proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate))


class _TemporalTransformerBlock(nn.Module):
    """AnimateDiff TemporalTransformerBlock: pre-LN self-attentions over the
    frames, then the pre-LN GEGLU feed-forward, each with a residual. Its
    LayerNorms take ``nn.LayerNorm``'s eps, 1e-5."""

    def __init__(self, channels: int, num_attention_blocks: int, num_heads: int, dtype, device):
        super().__init__()
        self.num_attention_blocks = num_attention_blocks
        for a in range(num_attention_blocks):
            self.add_module(f"norm_{a}", LayerNorm(channels, 1e-5, device=device))
            self.add_module(f"attention_{a}",
                            _TemporalSelfAttention(channels, num_heads, dtype, device))
        self.ff_norm = LayerNorm(channels, 1e-5, device=device)
        self.ff = _GEGLUFeedForward(channels, dtype, device)

    def forward(self, tokens):  # [S, T, C]
        for a in range(self.num_attention_blocks):
            normed = getattr(self, f"norm_{a}")(tokens)
            tokens = tokens + getattr(self, f"attention_{a}")(normed.to(tokens.dtype))
        return tokens + self.ff(self.ff_norm(tokens).to(tokens.dtype))


class _MotionModule(nn.Module):
    """AnimateDiff's TemporalTransformer3DModel as VDA uses it (``TemporalModule``):
    GroupNorm(32, eps 1e-6) over each frame -> proj_in -> temporal
    transformer blocks over the frame axis at each spatial location ->
    proj_out -> + residual."""

    def __init__(self, channels: int, num_transformer_blocks: int, num_attention_blocks: int,
                 dtype, device, num_heads: int = 8):
        super().__init__()
        self.num_transformer_blocks = num_transformer_blocks
        self.norm = GroupNorm(min(32, channels), channels, eps=1e-6, device=device)
        self.proj_in = Dense(channels, channels, dtype, device)
        for b in range(num_transformer_blocks):
            self.add_module(f"block_{b}", _TemporalTransformerBlock(
                channels, num_attention_blocks, num_heads, dtype, device))
        self.proj_out = Dense(channels, channels, dtype, device)

    def forward(self, x):  # [T H W C]
        t, h, w, c = x.shape
        tokens = self.proj_in(self.norm(x).to(x.dtype).reshape(t, h * w, c))
        tokens = tokens.transpose(0, 1)  # [H*W, T, C]: one sequence per location
        for b in range(self.num_transformer_blocks):
            tokens = getattr(self, f"block_{b}")(tokens)
        tokens = self.proj_out(tokens.transpose(0, 1))
        return x + tokens.reshape(t, h, w, c)


class _MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no mask):
    ``DenseGeneral`` q/k/v ``[in, H, hd]``, q scaled by 1/sqrt(hd) in the
    compute dtype, products and softmax in the compute dtype, ``out`` over
    the heads."""

    def __init__(self, features: int, num_heads: int, dtype, device):
        super().__init__()
        hd = features // num_heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((features,), (num_heads, hd), True, dtype, device))
        self.out = DenseGeneral((num_heads, hd), (features,), True, dtype, device)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)  # [..., T, H, hd]
        # sqrt(hd) rounded to the compute dtype, as flax divides by it.
        root = float(torch.tensor(math.sqrt(q.shape[-1])).to(self.dtype))
        logits = torch.einsum("...qhd,...khd->...hqk", q / root, k)
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        return self.out(torch.einsum("...hqk,...khd->...qhd", probs, v))


class _TemporalAttention(nn.Module):
    """Self-attention over the frame axis at each spatial location."""

    def __init__(self, features: int, dtype, device, num_heads: int = 4):
        super().__init__()
        self.norm = LayerNorm(features, device=device)
        self.attn = _MultiHeadDotProductAttention(features, num_heads, dtype, device)

    def forward(self, x):  # [T H W C]: T is the sequence axis
        t, h, w, c = x.shape
        tokens = x.permute(1, 2, 0, 3).reshape(h * w, t, c)
        tokens = tokens + self.attn(self.norm(tokens))
        return tokens.reshape(h, w, t, c).permute(2, 0, 1, 3)


class DPTHead(nn.Module):
    """DPT decode head: 4 tapped ViT token maps -> dense depth [T H W 1].

    ``use_temporal``: the from-scratch temporal attention after the coarsest
    fusion. ``use_motion_modules``: VDA's ``DPTHeadTemporal``:
    ``motion_module_0`` on the projected layer 3 (``out_channels[2]`` wide)
    and ``motion_module_1`` on the projected, resized layer 4
    (``out_channels[3]``), both before their ``scratch`` convolutions;
    ``motion_module_2`` and ``_3`` (``features`` wide) after ``fusion_3``
    and ``fusion_2``; ``head_conv2`` and ``head_conv3`` in f32, from an f32
    resize of ``head_conv1``'s output, as VDA runs ``output_conv2`` outside
    autocast. The two heads exclude each other.
    """

    def __init__(self, in_dim: int, features: int, out_channels: Sequence[int],
                 use_temporal: bool = True, use_motion_modules: bool = False,
                 motion_transformer_blocks: int = 1, motion_attention_blocks: int = 2,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        if use_temporal and use_motion_modules:
            raise ValueError("use_temporal and use_motion_modules are two temporal heads; "
                             "pick one")
        self.use_temporal, self.use_motion_modules = use_temporal, use_motion_modules
        oc = list(out_channels)
        for i in range(4):
            self.add_module(f"project_{i}", Conv(in_dim, oc[i], 1, dtype=dtype, device=device))
        self.resize_0 = ConvTranspose(oc[0], oc[0], 4, dtype=dtype, device=device)
        self.resize_1 = ConvTranspose(oc[1], oc[1], 2, dtype=dtype, device=device)
        self.resize_3 = Conv(oc[3], oc[3], 3, stride=2, padding=1, dtype=dtype, device=device)
        for i in range(4):
            self.add_module(f"scratch_{i}", Conv(oc[i], features, 3, padding=1, use_bias=False,
                                                 dtype=dtype, device=device))
        for i in range(4):
            self.add_module(f"fusion_{i}", _FusionBlock(features, i != 3, dtype, device))
        if use_temporal:
            self.temporal_3 = _TemporalAttention(features, dtype, device)
        self.motion_widths = (oc[2], oc[3], features, features) if use_motion_modules else ()
        for i, width in enumerate(self.motion_widths):
            self.add_module(f"motion_module_{i}", _MotionModule(
                width, motion_transformer_blocks, motion_attention_blocks, dtype, device))
        out_dtype = torch.float32 if use_motion_modules else dtype
        self.head_conv1 = Conv(features, features // 2, 3, padding=1, dtype=dtype, device=device)
        self.head_conv2 = Conv(features // 2, 32, 3, padding=1, dtype=out_dtype, device=device)
        self.head_conv3 = Conv(32, 1, 1, dtype=out_dtype, device=device)

    def _motion(self, idx: int, x):
        if not self.use_motion_modules:
            return x
        with span("tdspa.depth.motion"):
            return getattr(self, f"motion_module_{idx}")(x)

    def forward(self, taps, patch_hw, out_hw):
        """taps: 4x [T, Hp*Wp, D] token maps (CLS removed) -> [T H W 1]."""
        hp, wp = patch_hw
        with span("tdspa.depth.reassemble"):
            layers = []
            for i, tokens in enumerate(taps):
                x = getattr(self, f"project_{i}")(tokens.reshape(tokens.shape[0], hp, wp, -1))
                layers.append(getattr(self, f"resize_{i}")(x) if i in (0, 1, 3) else x)
        layers[2], layers[3] = self._motion(0, layers[2]), self._motion(1, layers[3])
        with span("tdspa.depth.reassemble"):
            rn = [getattr(self, f"scratch_{i}")(x) for i, x in enumerate(layers)]
        with span("tdspa.depth.fusion"):
            path = self.fusion_3(rn[3], out_hw=rn[2].shape[1:3])
        if self.use_temporal:
            with span("tdspa.depth.motion"):
                path = self.temporal_3(path)
        path = self._motion(2, path)
        with span("tdspa.depth.fusion"):
            path = self.fusion_2(path, rn[2], out_hw=rn[1].shape[1:3])
        path = self._motion(3, path)
        with span("tdspa.depth.fusion"):
            path = self.fusion_1(path, rn[1], out_hw=rn[0].shape[1:3])
            path = self.fusion_0(path, rn[0])
        with span("tdspa.depth.output"):
            h = self.head_conv1(path)
            h = resize_align_corners(h.to(self.head_conv2.dtype), out_hw)
            h = self.head_conv3(F.relu(self.head_conv2(h)))
            return F.relu(h)  # relative depth >= 0


def depth_window(estimator: "VideoDepthEstimator", frames, head_hw):
    """One group or window of normalised frames [W h w 3] through the
    backbone and the head -> depth [W oh ow 1] at ``head_hw``. Span
    ``tdspa.depth.window``; counts ``depth_window.windows`` and
    ``depth_window.frame_passes`` (frames through the backbone, padding and
    keyframes included)."""
    depth_window.windows += 1
    depth_window.frame_passes += frames.shape[0]
    p = estimator.vit_config.patch_size
    with span("tdspa.depth.window"):
        with span("tdspa.depth.backbone"):
            taps = estimator._taps(frames)
        return estimator.head(taps, (frames.shape[1] // p, frames.shape[2] // p), head_hw)


depth_window.windows = 0
depth_window.frame_passes = 0


class VideoDepthEstimator:
    """video [T H W 3] uint8 -> depth [T H W 1] on the device.

    Owns the weights, taps the backbone, groups the frames: in disjoint
    groups of ``frame_chunk`` with the from-scratch head (``use_temporal``),
    in VDA's overlapping windows (``vda_windows``) with the motion modules.
    ``input_size`` is the long side the backbone sees (snapped to patch
    multiples; 518 is the reference); ``output_scale`` < 1 runs the head's
    full-resolution tail smaller and upsamples the depth (approximate). The
    depth is resized back to the video's size bilinearly: with antialiasing
    after groups, with ``align_corners`` after VDA's windows, as VDA resizes
    it. Without ``params`` the first call warns and uses random weights from
    ``seed``.
    ``fused_attention=False`` keeps the plain attention on a GPU too.
    """

    def __init__(
        self,
        encoder: str = "vitb",
        params=None,
        use_temporal: bool = True,
        use_motion_modules: bool = False,
        motion_structure: dict | None = None,
        dtype=torch.bfloat16,
        frame_chunk: int = 8,
        vit_config: ViTConfig | None = None,
        head_cfg: dict | None = None,
        residual_dtype=torch.float32,
        output_scale: float = 1.0,
        input_size: int = 518,
        gelu_approximate: bool = False,
        fused_attention: bool = True,
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        cfg = dict(VDA_MODEL_CONFIGS[encoder])
        if head_cfg:
            cfg.update(head_cfg)
        self.cfg = cfg
        self.vit_config = vit_config or ViTConfig.preset(encoder)
        if not 0.0 < output_scale <= 1.0:
            raise ValueError(f"output_scale must be in (0, 1], got {output_scale}")
        if input_size < self.vit_config.patch_size:
            raise ValueError(f"input_size must be >= patch size "
                             f"({self.vit_config.patch_size}), got {input_size}")
        self.output_scale = float(output_scale)
        self.input_size = int(input_size)
        self.backbone = Dinov2(self.vit_config, dtype, residual_dtype, gelu_approximate,
                               fused_attention, self.device)
        motion_structure = motion_structure or {}
        self.head = DPTHead(
            self.vit_config.hidden_size, cfg["features"], cfg["out_channels"],
            use_temporal=use_temporal, use_motion_modules=use_motion_modules,
            motion_transformer_blocks=motion_structure.get("transformer_blocks", 1),
            motion_attention_blocks=motion_structure.get("attention_blocks", 2),
            dtype=dtype, device=self.device,
        )
        self.layer_idxs = tuple(cfg["layer_idxs"])
        self.frame_chunk = frame_chunk
        self.seed = seed
        self.has_weights = False
        if params is not None:
            self.load_params(params)

    @classmethod
    def from_checkpoint(cls, path: str, encoder: str = "vitb", **kwargs):
        """Load a released ``video_depth_anything_*.pth``: its motion modules,
        when present, as VDA's temporal head (the from-scratch ``temporal_3``
        stays off). Motion modules of other widths than that head's raise
        ``ValueError``."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
        structure = motion_module_structure(state_dict.keys())
        est = cls(encoder=encoder, use_temporal=False, use_motion_modules=structure is not None,
                  motion_structure=structure, **kwargs)
        if structure is not None:
            widths = [state_dict[f"head.motion_modules.{i}.temporal_transformer.proj_in.weight"]
                      .shape[1] for i in range(structure["modules"])]
            if widths != list(est.head.motion_widths):
                raise ValueError(
                    f"the checkpoint's motion modules are {widths} wide; VDA's temporal head "
                    f"places them at {list(est.head.motion_widths)} (out_channels[2], "
                    "out_channels[3], features, features)")
        est.load_params(convert_vda_params(state_dict, encoder=encoder,
                                           vit_config=kwargs.get("vit_config"),
                                           head_cfg=kwargs.get("head_cfg")))
        return est

    @property
    def params(self) -> dict:
        """The weights as a flax tree {"backbone": ..., "head": ...} (numpy)."""
        return {"backbone": params_to_flax(self.backbone.state_dict()),
                "head": params_to_flax(self.head.state_dict())}

    def load_params(self, params: dict) -> None:
        self.backbone.load_state_dict(params_from_flax(params["backbone"]))
        self.head.load_state_dict(params_from_flax(params["head"]))
        self.has_weights = True

    def init_params(self, seed: int | None = None) -> None:
        """Random weights with the flax initialisers' laws, from ``seed``."""
        seed = self.seed if seed is None else seed
        init_parameters(self.backbone, seed, self.device)
        init_parameters(self.head, seed + 1, self.device)
        self.has_weights = True

    def chunk_invariant(self, chunk: int) -> bool:
        """Whether depth over consecutive chunks of ``chunk`` frames equals the
        whole video's: with disjoint groups, where the chunk is a multiple of
        the group; never with VDA's windows, which overlap and read keyframes
        of earlier windows."""
        return not self.head.use_motion_modules and chunk % self.frame_chunk == 0

    def _taps(self, frames):
        """Tapped-layer token maps, final-layernormed (DINOv2's
        ``get_intermediate_layers(norm=True)``), CLS dropped."""
        _, inter = self.backbone(frames, taps=self.layer_idxs)
        ln = self.backbone.layernorm
        eps = self.vit_config.layer_norm_eps
        taps = []
        for tokens in inter:
            tokens = tokens.float()
            mu = tokens.mean(-1, keepdim=True)
            var = torch.square(tokens - mu).mean(-1, keepdim=True)
            tokens = (tokens - mu) * torch.rsqrt(var + eps)
            taps.append((tokens * ln.scale + ln.bias)[:, 1:])
        return taps

    @torch.inference_mode()
    def __call__(self, video, input_size: int | None = None) -> torch.Tensor:
        """video [T H W 3] uint8 -> depth [T H W 1] on the device."""
        if input_size is None:
            input_size = self.input_size
        if not self.has_weights:
            logger.warning("VideoDepthEstimator has no weights; depth will use RANDOM "
                           "weights (shape-correct, not meaningful)")
            self.init_params()
        t, h, w = video.shape[:3]
        p = self.vit_config.patch_size
        # Resize so the long side ~ input_size, snapped to patch multiples.
        scale = input_size / max(h, w)
        th = max(int(round(h * scale / p)) * p, p)
        tw = max(int(round(w * scale / p)) * p, p)
        return self._forward(normalize_frames(video, self.device, (th, tw)), (h, w))

    def _forward(self, frames, out_hw):
        """Normalised frames -> depth resized back to ``out_hw``."""
        t, gh, gw = frames.shape[:3]
        head_hw = (max(int(round(gh * self.output_scale)), 1),
                   max(int(round(gw * self.output_scale)), 1))
        if self.head.use_motion_modules:
            parts = []
            for inputs, first in vda_windows(t):
                index = torch.tensor(inputs, device=frames.device)
                depth = depth_window(self, frames.index_select(0, index), head_hw)[first:]
                with span("tdspa.depth.output"):
                    parts.append(resize_align_corners(depth, out_hw))
            return torch.cat(parts)[:t]
        chunk = self.frame_chunk
        pad = (-t) % chunk
        if pad:
            frames = torch.cat([frames, frames[-1:].expand((pad,) + frames.shape[1:])])
        depth = torch.cat([depth_window(self, frames[i : i + chunk], head_hw)
                           for i in range(0, t + pad, chunk)])[:t]
        return resize(depth, out_hw, method="bilinear")


class ConstantDepthProvider:
    """Unit depth everywhere (the reference's z = 1 fallback)."""

    def __call__(self, video, fps: float = 30.0) -> np.ndarray:
        t, h, w = video.shape[:3]
        return np.ones((t, h, w, 1), np.float32)


def convert_vda_params(state_dict, encoder: str = "vitb", vit_config: ViTConfig | None = None,
                       head_cfg: dict | None = None) -> dict:
    """``video_depth_anything_*.pth`` torch state_dict -> flax tree (numpy).

    The torch-hub DINOv2 backbone (``pretrained.*``: fused qkv,
    ``ls{1,2}.gamma`` layer scale) maps onto ``Dinov2`` and the
    Depth-Anything-V2 DPT head (``head.*``) onto ``DPTHead``; motion modules
    through ``_convert_motion_modules``. Returns ``{"backbone", "head"}``.
    Unconverted keys (``mask_token``, the parameter-only
    ``refinenet4.resConfUnit1``) are logged and dropped.
    """
    cfg = dict(VDA_MODEL_CONFIGS[encoder])
    if head_cfg:
        cfg.update(head_cfg)
    vit = vit_config or ViTConfig.preset(encoder)

    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}
    used = set()

    def t(name):
        used.add(name)
        return sd[name]

    def norm(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def dense(name):
        return {"kernel": t(f"{name}.weight").T, "bias": t(f"{name}.bias")}

    def conv(name):
        # torch conv [out,in,kh,kw] -> flax [kh,kw,in,out]
        return {"kernel": t(f"{name}.weight").transpose(2, 3, 1, 0), "bias": t(f"{name}.bias")}

    def conv_nobias(name):
        return {"kernel": t(f"{name}.weight").transpose(2, 3, 1, 0)}

    def deconv(name):
        # torch ConvTranspose2d [in,out,kh,kw]; flax ConvTranspose correlates
        # with its kernel unflipped, so the torch weights flip spatially.
        w = t(f"{name}.weight").transpose(2, 3, 0, 1)[::-1, ::-1]
        return {"kernel": np.ascontiguousarray(w), "bias": t(f"{name}.bias")}

    d, h = vit.hidden_size, vit.num_heads
    hd = d // h
    backbone: dict = {
        "cls_token": t("pretrained.cls_token"),
        "pos_embed": t("pretrained.pos_embed"),
        "patch_embed": {
            "kernel": t("pretrained.patch_embed.proj.weight").transpose(2, 3, 1, 0),
            "bias": t("pretrained.patch_embed.proj.bias"),
        },
        "layernorm": norm("pretrained.norm"),
    }
    for i in range(vit.num_layers):
        pre = f"pretrained.blocks.{i}"
        qkv_w = t(f"{pre}.attn.qkv.weight")  # [3d, d] rows = [q; k; v]
        qkv_b = t(f"{pre}.attn.qkv.bias")

        def split(j):
            return {"kernel": qkv_w[j * d:(j + 1) * d].T.reshape(d, h, hd),
                    "bias": qkv_b[j * d:(j + 1) * d].reshape(h, hd)}

        backbone[f"layer_{i}"] = {
            "norm1": norm(f"{pre}.norm1"),
            "norm2": norm(f"{pre}.norm2"),
            "attention": {
                "query": split(0),
                "key": split(1),
                "value": split(2),
                "output": {"kernel": t(f"{pre}.attn.proj.weight").T.reshape(h, hd, d),
                           "bias": t(f"{pre}.attn.proj.bias")},
            },
            "layer_scale1": t(f"{pre}.ls1.gamma"),
            "layer_scale2": t(f"{pre}.ls2.gamma"),
            "fc1": dense(f"{pre}.mlp.fc1"),
            "fc2": dense(f"{pre}.mlp.fc2"),
        }

    def rcu(name):
        return {"conv1": conv(f"{name}.conv1"), "conv2": conv(f"{name}.conv2")}

    head: dict = {}
    for i in range(4):
        head[f"project_{i}"] = conv(f"head.projects.{i}")
        head[f"scratch_{i}"] = conv_nobias(f"head.scratch.layer{i + 1}_rn")
    head["resize_0"] = deconv("head.resize_layers.0")
    head["resize_1"] = deconv("head.resize_layers.1")
    head["resize_3"] = conv("head.resize_layers.3")
    # refinenet4..1 fuse top-down; refinenet4 takes no skip, so its
    # resConfUnit1 exists in the checkpoint but is dead: consume it.
    for flax_name, torch_name, has_skip in [("fusion_3", "refinenet4", False),
                                            ("fusion_2", "refinenet3", True),
                                            ("fusion_1", "refinenet2", True),
                                            ("fusion_0", "refinenet1", True)]:
        pre = f"head.scratch.{torch_name}"
        block = {"rcu2": rcu(f"{pre}.resConfUnit2"), "project": conv(f"{pre}.out_conv")}
        dead_or_live = rcu(f"{pre}.resConfUnit1")
        if has_skip:
            block["rcu1"] = dead_or_live
        head[flax_name] = block
    head["head_conv1"] = conv("head.scratch.output_conv1")
    head["head_conv2"] = conv("head.scratch.output_conv2.0")
    head["head_conv3"] = conv("head.scratch.output_conv2.2")

    _convert_motion_modules(sd, used, head, t, norm, dense)

    unmapped = sorted(set(sd) - used)
    if unmapped:
        logger.warning("convert_vda_params: %d keys not converted: %s", len(unmapped),
                       unmapped[:10])
    return {"backbone": backbone, "head": head}


def motion_module_structure(keys) -> dict | None:
    """VDA motion-module counts from state_dict keys; None if absent.

    Returns {'modules': M, 'transformer_blocks': B, 'attention_blocks': A}.
    """
    mods, blocks, attns = set(), set(), set()
    for k in keys:
        m = re.match(
            r"head\.motion_modules\.(\d+)\.temporal_transformer\."
            r"(?:transformer_blocks\.(\d+)\.(?:attention_blocks\.(\d+)\.)?)?",
            k,
        )
        if m:
            mods.add(int(m.group(1)))
            if m.group(2) is not None:
                blocks.add(int(m.group(2)))
            if m.group(3) is not None:
                attns.add(int(m.group(3)))
    if not mods:
        return None
    return {"modules": max(mods) + 1,
            "transformer_blocks": max(blocks) + 1 if blocks else 1,
            "attention_blocks": max(attns) + 1 if attns else 1}


def _convert_motion_modules(sd, used, head, t, norm, dense):
    """head.motion_modules.{i}.temporal_transformer.* -> motion_module_{i}.

    AnimateDiff TemporalTransformer3DModel layout: norm (GroupNorm),
    proj_in/out, transformer_blocks.{b} with attention_blocks.{a}
    (to_q/to_k/to_v bias-free, to_out.0, the pos_encoder.pe buffer, which is
    recomputed), norms.{a}, ff (GEGLU net.0.proj + net.2), ff_norm.
    """
    structure = motion_module_structure(sd)
    if structure is None:
        return

    def dense_nobias(name):
        return {"kernel": t(f"{name}.weight").T}

    for i in range(structure["modules"]):
        pre = f"head.motion_modules.{i}.temporal_transformer"
        module: dict = {"norm": norm(f"{pre}.norm"), "proj_in": dense(f"{pre}.proj_in"),
                        "proj_out": dense(f"{pre}.proj_out")}
        for b in range(structure["transformer_blocks"]):
            bpre = f"{pre}.transformer_blocks.{b}"
            block: dict = {"ff_norm": norm(f"{bpre}.ff_norm"),
                           "ff": {"geglu_proj": dense(f"{bpre}.ff.net.0.proj"),
                                  "out": dense(f"{bpre}.ff.net.2")}}
            for a in range(structure["attention_blocks"]):
                apre = f"{bpre}.attention_blocks.{a}"
                block[f"norm_{a}"] = norm(f"{bpre}.norms.{a}")
                block[f"attention_{a}"] = {"to_q": dense_nobias(f"{apre}.to_q"),
                                           "to_k": dense_nobias(f"{apre}.to_k"),
                                           "to_v": dense_nobias(f"{apre}.to_v"),
                                           "to_out": dense(f"{apre}.to_out.0")}
                pe_key = f"{apre}.pos_encoder.pe"
                if pe_key in sd:
                    used.add(pe_key)  # deterministic buffer; recomputed
            module[f"block_{b}"] = block
        head[f"motion_module_{i}"] = module


def extract_depth_features(video: np.ndarray, provider=None, fps: float = 30.0,
                           encoder: str = "vitb") -> np.ndarray:
    """Reference-compatible entry -> host [T H W 1]; the pipeline calls the
    provider itself to keep the depth on the device."""
    if provider is None:
        provider = VideoDepthEstimator(encoder=encoder)
    out = provider(video, fps=fps) if _wants_fps(provider) else provider(video)
    if isinstance(out, torch.Tensor):
        out = out.float().cpu().numpy()
    return np.asarray(out, np.float32)


def _wants_fps(provider) -> bool:
    import inspect

    try:
        return "fps" in inspect.signature(provider.__call__).parameters
    except (TypeError, ValueError):
        return False
