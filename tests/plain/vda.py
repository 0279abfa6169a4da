"""Plain reference of Video Depth Anything (github.com/DepthAnything/Video-Depth-Anything,
arXiv:2501.12375) as the scoring pipeline runs it: a video's depth, window by window.
Plain float32 PyTorch over a dict of weights named as the released
``video_depth_anything_*.pth`` state_dict; it imports nothing of the port, of JAX or of
the JAX package. The test suite holds it as ``tests/plain/vda.py``, the benchmark as
``benchmark/reference/vda.py``: the two files are one text.

Written from ``video_depth_anything/video_depth.py`` (``infer_video_depth``),
``dpt_temporal.py`` (``DPTHeadTemporal``), ``dpt.py`` (Depth-Anything-V2's fusion blocks)
and ``motion_module/motion_module.py``, with the torch-hub DINOv2 under ``pretrained.*``:

* preprocess: frames / 255, resized to the long side ``input_size`` at patch multiples,
  ImageNet-normalised;
* the windows: ``window`` frames (32), the video padded with copies of its last frame;
  each later window starts ``window - overlap`` (22) frames on, and its first ``overlap``
  (10) inputs are the previous window's inputs at ``keyframes``; window 0 gives its frames,
  a later one the frames after its first ``overlap``;
* the encoder (fused ``qkv``, layer scales ``ls{1,2}.gamma``, exact GELU MLP, eps 1e-6):
  the tokens after each block of ``layer_idxs``, through the final LayerNorm, CLS dropped;
* the head: ``projects`` (1x1), ``resize_layers`` (ConvT 4/4, ConvT 2/2, identity, 3x3
  stride 2); ``motion_modules[0]`` on layer 3 and ``[1]`` on layer 4 before
  ``layer{3,4}_rn``; ``refinenet4``, ``motion_modules[2]``, ``refinenet3``,
  ``motion_modules[3]``, ``refinenet2``, ``refinenet1`` (residual conv units, align-corners
  resizes, 1x1 ``out_conv``); ``output_conv1`` (3x3), an align-corners resize to the input
  size, ``output_conv2`` (3x3, ReLU, 1x1, ReLU);
* a motion module (AnimateDiff ``TemporalTransformer3DModel``): GroupNorm over each frame,
  ``proj_in``, transformer blocks over the frame axis at each location (per attention
  block: LayerNorm, sinusoidal positions added, bias-free q/k/v in ``heads`` heads,
  softmax of q k^T / sqrt(head), ``to_out.0``, a residual; then LayerNorm, GEGLU
  ``h * gelu(gate)`` 4 x wide, ``ff.net.2``, a residual), ``proj_out``, the module's
  residual;
* the depth resized to the frame size, bilinear with ``align_corners``.

Departures from VDA, each deliberate:

* the resize into the encoder is the program's: bilinear, half-pixel, antialiased when it
  shrinks, with the long side at ``input_size``, where VDA resizes with cv2's cubic and
  brings the short side to it (the same size for square frames);
* float32 throughout; VDA runs fp16 autocast, the program bf16;
* VDA's cross-window scale-and-shift alignment is not run: each window gives its new frames
  as the network computes them;
* the ``pos_encoder.pe`` buffers are recomputed, not read; ``pretrained.mask_token`` and
  ``refinenet4.resConfUnit1``, which no forward reads, are not read; the position table is
  not resized, so frames must come out at the encoder's native grid (518 -> 37 x 37).

It computes in blocks so that one 32-frame window fits: the encoder and the stages after
``motion_modules[3]`` over ``frame_block`` frames at a time, the motion modules over
``location_block`` locations at a time. ``rnd`` is applied to each operand of every matrix
product and convolution: ``float`` for the reference; the benchmark passes its control's
rounding. Building one switches TF32 off, so that a product on a GPU is a float32 one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUTPUT_BIAS = "head.scratch.output_conv2.2.bias"


def motion_widths(cfg: dict) -> list[int]:
    """Widths of motion modules 0-3: layer 3's and layer 4's projections, then the
    head's features twice."""
    oc = cfg["out_channels"]
    return [oc[2], oc[3], cfg["features"], cfg["features"]]


def param_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str, int]]:
    """name -> (shape, law, fan_in) of every weight of the released state_dict that a
    forward can read (``refinenet4.resConfUnit1`` is in the file and read by no forward;
    ``pretrained.mask_token`` and the ``pe`` buffers are left out). Laws: ``kernel``
    normal of variance 1/fan_in, ``bias`` small, ``scale`` near 1, ``state`` standard
    normal."""
    enc, motion = cfg["encoder"], cfg["motion"]
    d, p = enc["hidden_size"], enc["patch_size"]
    native = enc["image_size"] // p
    oc, f = cfg["out_channels"], cfg["features"]
    out: dict = {}

    def linear(name, n_in, n_out, bias=True):
        out[f"{name}.weight"] = ((n_out, n_in), "kernel", n_in)
        if bias:
            out[f"{name}.bias"] = ((n_out,), "bias", 0)

    def conv(name, n_in, n_out, k, bias=True):
        out[f"{name}.weight"] = ((n_out, n_in, k, k), "kernel", n_in * k * k)
        if bias:
            out[f"{name}.bias"] = ((n_out,), "bias", 0)

    def deconv(name, c, k):  # stride k: each output pixel sees one input pixel
        out[f"{name}.weight"] = ((c, c, k, k), "kernel", c)
        out[f"{name}.bias"] = ((c,), "bias", 0)

    def norm(name, c):
        out[f"{name}.weight"] = ((c,), "scale", 0)
        out[f"{name}.bias"] = ((c,), "bias", 0)

    out["pretrained.cls_token"] = ((1, 1, d), "state", 0)
    out["pretrained.pos_embed"] = ((1, native * native + 1, d), "state", 0)
    conv("pretrained.patch_embed.proj", 3, d, p)
    for i in range(enc["num_layers"]):
        pre = f"pretrained.blocks.{i}"
        norm(f"{pre}.norm1", d)
        linear(f"{pre}.attn.qkv", d, 3 * d)
        linear(f"{pre}.attn.proj", d, d)
        out[f"{pre}.ls1.gamma"] = ((d,), "scale", 0)
        norm(f"{pre}.norm2", d)
        linear(f"{pre}.mlp.fc1", d, d * enc["mlp_ratio"])
        linear(f"{pre}.mlp.fc2", d * enc["mlp_ratio"], d)
        out[f"{pre}.ls2.gamma"] = ((d,), "scale", 0)
    norm("pretrained.norm", d)
    for i, c in enumerate(oc):
        conv(f"head.projects.{i}", d, c, 1)
    deconv("head.resize_layers.0", oc[0], 4)
    deconv("head.resize_layers.1", oc[1], 2)
    conv("head.resize_layers.3", oc[3], oc[3], 3)
    for i, c in enumerate(oc):
        conv(f"head.scratch.layer{i + 1}_rn", c, f, 3, bias=False)
    for r in range(1, 5):
        pre = f"head.scratch.refinenet{r}"
        for unit in (1, 2):
            for k in (1, 2):
                conv(f"{pre}.resConfUnit{unit}.conv{k}", f, f, 3)
        conv(f"{pre}.out_conv", f, f, 1)
    conv("head.scratch.output_conv1", f, f // 2, 3)
    conv("head.scratch.output_conv2.0", f // 2, 32, 3)
    conv("head.scratch.output_conv2.2", 32, 1, 1)
    for i, c in enumerate(motion_widths(cfg)):
        pre = f"head.motion_modules.{i}.temporal_transformer"
        norm(f"{pre}.norm", c)
        linear(f"{pre}.proj_in", c, c)
        linear(f"{pre}.proj_out", c, c)
        for b in range(motion["num_transformer_block"]):
            block = f"{pre}.transformer_blocks.{b}"
            for a in range(motion["num_attention_blocks"]):
                attn = f"{block}.attention_blocks.{a}"
                for name in ("to_q", "to_k", "to_v"):
                    linear(f"{attn}.{name}", c, c, bias=False)
                linear(f"{attn}.to_out.0", c, c)
                norm(f"{block}.norms.{a}", c)
            norm(f"{block}.ff_norm", c)
            linear(f"{block}.ff.net.0.proj", c, 2 * motion["ff_mult"] * c)
            linear(f"{block}.ff.net.2", motion["ff_mult"] * c, c)
    return out


def sinusoids(length: int, dim: int, device) -> torch.Tensor:
    """AnimateDiff's ``PositionalEncoding`` table [length, dim]: sin on even channels, cos
    on odd ones."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    table = torch.zeros((length, dim), device=device)
    table[:, 0::2] = torch.sin(position * div)
    table[:, 1::2] = torch.cos(position * div)
    return table


class VDA:
    """The forward over ``weights`` (name -> tensor), ``cfg`` the configuration's depth
    block (``encoder``, ``layer_idxs``, ``features``, ``out_channels``, ``motion``,
    ``window``, ``overlap``, ``keyframes``, ``input_size``)."""

    def __init__(self, cfg: dict, weights: dict, rnd=None, frame_block: int = 4,
                 location_block: int = 4096):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.w = cfg, weights
        self.rnd = rnd or (lambda x: x.float())
        self.frame_block, self.location_block = frame_block, location_block

    # Layers, each product's operands through ``rnd``.
    def linear(self, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        y = self.rnd(x) @ self.rnd(self.w[f"{name}.weight"]).T
        return y + self.w[f"{name}.bias"].float() if bias else y

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
             bias: bool = True) -> torch.Tensor:
        b = self.w[f"{name}.bias"].float() if bias else None
        return F.conv2d(self.rnd(x), self.rnd(self.w[f"{name}.weight"]), b, stride, padding)

    def deconv(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        return F.conv_transpose2d(self.rnd(x), self.rnd(self.w[f"{name}.weight"]),
                                  self.w[f"{name}.bias"].float(), stride)

    def layer_norm(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"].float(),
                            self.w[f"{name}.bias"].float(), eps)

    def attend(self, q, k, v) -> torch.Tensor:
        """q, k, v [B, S, H, Dh] -> [B, S, H Dh]."""
        logits = torch.einsum("bqhd,bkhd->bhqk", self.rnd(q), self.rnd(k))
        probs = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", self.rnd(probs), self.rnd(v))
        return out.reshape(out.shape[0], out.shape[1], -1)

    # The encoder.
    def encoder(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        """pixels [B, 3, H, W] at the native grid -> the taps [B, h w, D]."""
        enc = self.cfg["encoder"]
        p, eps, heads = enc["patch_size"], enc["layer_norm_eps"], enc["num_heads"]
        x = self.conv("pretrained.patch_embed.proj", pixels, stride=p)
        batch, dim, gh, gw = x.shape
        table = self.w["pretrained.pos_embed"].float()
        if table.shape[1] != gh * gw + 1:
            raise ValueError(f"a {gh}x{gw} patch grid is not the encoder's native "
                             f"{table.shape[1] - 1} positions")
        x = x.flatten(2).transpose(1, 2)
        cls = self.w["pretrained.cls_token"].float().expand(batch, 1, dim)
        x = torch.cat([cls, x], dim=1) + table
        taps = []
        for i in range(enc["num_layers"]):
            pre = f"pretrained.blocks.{i}"
            qkv = self.linear(f"{pre}.attn.qkv", self.layer_norm(f"{pre}.norm1", x, eps))
            q, k, v = qkv.reshape(batch, x.shape[1], 3, heads, dim // heads).unbind(2)
            h = self.linear(f"{pre}.attn.proj", self.attend(q, k, v))
            x = x + self.w[f"{pre}.ls1.gamma"].float() * h
            h = self.linear(f"{pre}.mlp.fc1", self.layer_norm(f"{pre}.norm2", x, eps))
            h = self.linear(f"{pre}.mlp.fc2", F.gelu(h))
            x = x + self.w[f"{pre}.ls2.gamma"].float() * h
            if i in self.cfg["layer_idxs"]:
                taps.append(self.layer_norm("pretrained.norm", x, eps)[:, 1:])
        return taps

    # The motion modules.
    def temporal_attention(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        """x [L, T, C]: one sequence over the frames at each location."""
        locations, frames, c = x.shape
        heads = self.cfg["motion"]["num_attention_heads"]
        x = x + sinusoids(frames, c, x.device)

        def split(name):
            return self.linear(f"{pre}.{name}", x, bias=False).reshape(
                locations, frames, heads, c // heads)

        return self.linear(f"{pre}.to_out.0", self.attend(split("to_q"), split("to_k"),
                                                          split("to_v")))

    def temporal_block(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg["motion"]["layer_norm_eps"]
        for a in range(self.cfg["motion"]["num_attention_blocks"]):
            x = x + self.temporal_attention(f"{pre}.attention_blocks.{a}",
                                            self.layer_norm(f"{pre}.norms.{a}", x, eps))
        h, gate = self.linear(f"{pre}.ff.net.0.proj",
                              self.layer_norm(f"{pre}.ff_norm", x, eps)).chunk(2, dim=-1)
        return x + self.linear(f"{pre}.ff.net.2", h * F.gelu(gate))

    def motion_module(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x [T, C, H, W] -> the same, frames coupled at each location."""
        motion = self.cfg["motion"]
        pre = f"head.motion_modules.{i}.temporal_transformer"
        frames, c, h, w = x.shape
        normed = F.group_norm(x, motion["norm_num_groups"], self.w[f"{pre}.norm.weight"].float(),
                              self.w[f"{pre}.norm.bias"].float(), motion["group_norm_eps"])
        tokens = normed.permute(0, 2, 3, 1).reshape(frames, h * w, c)
        out = torch.empty_like(tokens)
        for s in range(0, h * w, self.location_block):
            seq = self.linear(f"{pre}.proj_in", tokens[:, s : s + self.location_block])
            seq = seq.transpose(0, 1)
            for b in range(motion["num_transformer_block"]):
                seq = self.temporal_block(f"{pre}.transformer_blocks.{b}", seq)
            out[:, s : s + self.location_block] = self.linear(f"{pre}.proj_out",
                                                              seq.transpose(0, 1))
        return x + out.reshape(frames, h, w, c).permute(0, 3, 1, 2)

    # The head.
    def unit(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{pre}.conv1", F.relu(x), padding=1)
        return x + self.conv(f"{pre}.conv2", F.relu(h), padding=1)

    def fusion(self, r: int, x: torch.Tensor, skip=None, size=None) -> torch.Tensor:
        pre = f"head.scratch.refinenet{r}"
        if skip is not None:
            x = x + self.unit(f"{pre}.resConfUnit1", skip)
        x = self.unit(f"{pre}.resConfUnit2", x)
        size = size or (x.shape[2] * 2, x.shape[3] * 2)
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.conv(f"{pre}.out_conv", x)

    def head(self, taps: list[torch.Tensor], grid: tuple[int, int]) -> torch.Tensor:
        """The window's taps -> depth [W, H, W] at the input size."""
        gh, gw = grid
        frames = taps[0].shape[0]
        layers = []
        for i, tokens in enumerate(taps):
            x = self.conv(f"head.projects.{i}",
                          tokens.transpose(1, 2).reshape(frames, -1, gh, gw))
            if i in (0, 1):
                x = self.deconv(f"head.resize_layers.{i}", x, 4 if i == 0 else 2)
            elif i == 3:
                x = self.conv("head.resize_layers.3", x, stride=2, padding=1)
            layers.append(x)
        layers[2] = self.motion_module(0, layers[2])
        layers[3] = self.motion_module(1, layers[3])
        rn = [self.conv(f"head.scratch.layer{i + 1}_rn", x, padding=1, bias=False)
              for i, x in enumerate(layers)]
        path = self.motion_module(2, self.fusion(4, rn[3], size=rn[2].shape[2:]))
        path = self.motion_module(3, self.fusion(3, path, rn[2], size=rn[1].shape[2:]))
        p = self.cfg["encoder"]["patch_size"]
        out = []
        for s in range(0, frames, self.frame_block):
            b = slice(s, s + self.frame_block)
            x = self.fusion(2, path[b], rn[1][b], size=rn[0].shape[2:])
            x = self.conv("head.scratch.output_conv1", self.fusion(1, x, rn[0][b]), padding=1)
            x = F.interpolate(x, size=(gh * p, gw * p), mode="bilinear", align_corners=True)
            x = F.relu(self.conv("head.scratch.output_conv2.0", x, padding=1))
            out.append(F.relu(self.conv("head.scratch.output_conv2.2", x))[:, 0])
        return torch.cat(out)

    def window(self, pixels: torch.Tensor) -> torch.Tensor:
        """One window's pixels [W, 3, H, W] -> depth [W, H, W]."""
        p = self.cfg["encoder"]["patch_size"]
        parts = [self.encoder(pixels[s : s + self.frame_block])
                 for s in range(0, pixels.shape[0], self.frame_block)]
        taps = [torch.cat(tap) for tap in zip(*parts)]
        return self.head(taps, (pixels.shape[2] // p, pixels.shape[3] // p))

    def preprocess(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 [T, H, W, 3] -> f32 [T, 3, H', W'], the long side at ``input_size``."""
        p = self.cfg["encoder"]["patch_size"]
        x = frames.float().permute(0, 3, 1, 2) / 255.0
        height, width = x.shape[2:]
        scale = self.cfg["input_size"] / max(height, width)
        size = (max(int(round(height * scale / p)) * p, p),
                max(int(round(width * scale / p)) * p, p))
        if size != (height, width):
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                              antialias=True)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
        return (x - mean) / std

    def video(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames [T, H, W, 3] -> depth [T, H, W, 1], window by window as
        ``infer_video_depth`` runs them."""
        window, overlap = self.cfg["window"], self.cfg["overlap"]
        pixels = self.preprocess(frames)
        count, height, width = frames.shape[:3]
        stride = window - overlap
        padded = list(range(count)) + [count - 1] * ((stride - count % stride) % stride + overlap)
        depth, previous = [], None
        for start in range(0, count, stride):
            inputs = padded[start : start + window]
            if previous is not None:
                inputs[:overlap] = [previous[k] for k in self.cfg["keyframes"]]
            out = self.window(pixels[inputs])
            depth.append(out if previous is None else out[overlap:])
            previous = inputs
        depth = torch.cat(depth)[:count, None]
        depth = F.interpolate(depth, size=(height, width), mode="bilinear", align_corners=True)
        return depth.permute(0, 2, 3, 1)
