"""Plain reference of the DINOv2 backbone (HF ``Dinov2Model``,
``facebook/dinov2-*``) as the serving pipeline runs it: a video's frames
resized to patch multiples and ImageNet-normalised, then the ViT's last
hidden state as a grid of patch tokens. Plain float32 PyTorch over a dict of
weights named as the published checkpoint's ``state_dict``; it imports
nothing of the port, of JAX or of the JAX package.

Written from ``transformers/models/dinov2/modeling_dinov2.py`` and
``facebookresearch/dinov2`` (``vision_transformer.py::vit_giant2``,
``layers/swiglu_ffn.py::SwiGLUFFNFused``):

* preprocess (the pipeline's, not HF's image processor): frames / 255,
  bilinear resize with antialiasing to the largest patch multiples, then
  (x - mean) / std with ImageNet's statistics;
* patch embedding: a p x p convolution of stride p (here as a product over
  the unfolded patches), the CLS token first, plus the position table: the
  CLS slot and the native grid resized to the frame's patch grid as HF
  resizes it (``F.interpolate`` to that size, bicubic, a = -0.75,
  ``align_corners=False``, no antialiasing);
* pre-LN blocks ``x + ls1 * attn(norm1(x))``, ``x + ls2 * ffn(norm2(x))``:
  qkv-bias multi-head attention, softmax of q k^T / sqrt(head); the FFN the
  GELU MLP or, where ``ffn`` is ``swiglu``, ``weights_out(silu(x1) * x2)``
  with ``x1, x2 = chunk(weights_in(x), 2)`` and hidden width
  ``(int(4 D * 2 / 3) + 7) // 8 * 8`` (4096 at 1536);
* a final LayerNorm; the patch tokens (CLS dropped) as [T, h, w, D].

Departures from HF: ``embeddings.mask_token`` is not read (HF's forward
without a mask never uses it); evaluation mode (no dropout or drop path);
the facebookresearch code resizes the position table by scale factors
``(h + 0.1) / sqrt(N)`` where HF (followed here) gives the size.

``Precision`` decides what each matrix product (projections, FFN, patch
embedding, attention's two products) rounds to: f32 is the reference, fp8
the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def ffn_width(cfg: dict) -> int:
    hidden = int(cfg["hidden_size"] * cfg["mlp_ratio"])
    return (int(hidden * 2 / 3) + 7) // 8 * 8 if cfg["ffn"] == "swiglu" else hidden


def param_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str, int]]:
    """name -> (shape, law, fan_in) of every weight the forward reads, under
    the checkpoint's names (laws of ``benchmark/harness/weights.py``: matrices
    normal of variance 1/fan_in, biases small, norm and layer scales near 1,
    CLS token and position table standard normal)."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    native = cfg["image_size"] // p
    h = ffn_width(cfg)
    out: dict = {
        "embeddings.cls_token": ((1, 1, d), "state", 0),
        "embeddings.position_embeddings": ((1, native * native + 1, d), "state", 0),
        "embeddings.patch_embeddings.projection.weight": ((d, 3, p, p), "kernel", 3 * p * p),
        "embeddings.patch_embeddings.projection.bias": ((d,), "bias", 0),
    }

    def linear(name, n_in, n_out):
        out[f"{name}.weight"] = ((n_out, n_in), "kernel", n_in)
        out[f"{name}.bias"] = ((n_out,), "bias", 0)

    def norm(name):
        out[f"{name}.weight"] = ((d,), "scale", 0)
        out[f"{name}.bias"] = ((d,), "bias", 0)

    ffn = ((("weights_in", d, 2 * h), ("weights_out", h, d)) if cfg["ffn"] == "swiglu"
           else (("fc1", d, h), ("fc2", h, d)))
    for i in range(cfg["num_layers"]):
        pre = f"encoder.layer.{i}"
        norm(f"{pre}.norm1")
        for name in ("query", "key", "value"):
            linear(f"{pre}.attention.attention.{name}", d, d)
        linear(f"{pre}.attention.output.dense", d, d)
        out[f"{pre}.layer_scale1.lambda1"] = ((d,), "scale", 0)
        norm(f"{pre}.norm2")
        for name, n_in, n_out in ffn:
            linear(f"{pre}.mlp.{name}", n_in, n_out)
        out[f"{pre}.layer_scale2.lambda1"] = ((d,), "scale", 0)
    norm("layernorm")
    return out


def preprocess(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> f32 [T, 3, H', W'] at the largest patch multiples."""
    x = frames.float().permute(0, 3, 1, 2) / 255.0
    height, width = x.shape[2] // patch * patch, x.shape[3] // patch * patch
    if (height, width) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                          antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


class Backbone:
    """The forward over ``weights`` (name -> tensor) at ``precision``."""

    def __init__(self, cfg: dict, weights: dict, precision: Precision | None = None):
        self.cfg, self.w = cfg, weights
        self.p = precision or Precision("f32")

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.p.mm(x, self.w[f"{name}.weight"].T) + self.w[f"{name}.bias"]

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"].float(),
                            self.w[f"{name}.bias"].float(), self.cfg["layer_norm_eps"])

    def position_table(self, grid_h: int, grid_w: int) -> torch.Tensor:
        table = self.w["embeddings.position_embeddings"].float()
        side = math.isqrt(table.shape[1] - 1)
        if (grid_h, grid_w) == (side, side):
            return table
        dim = table.shape[-1]
        grid = table[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(grid_h, grid_w), mode="bicubic", align_corners=False)
        return torch.cat([table[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        p = self.cfg["patch_size"]
        batch, _, height, width = pixels.shape
        gh, gw = height // p, width // p
        patches = pixels.reshape(batch, 3, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        kernel = self.w["embeddings.patch_embeddings.projection.weight"]
        x = self.p.mm(patches.reshape(batch, gh * gw, -1), kernel.reshape(kernel.shape[0], -1).T)
        x = x + self.w["embeddings.patch_embeddings.projection.bias"]
        cls = self.w["embeddings.cls_token"].float().expand(batch, 1, x.shape[-1])
        return torch.cat([cls, x], dim=1) + self.position_table(gh, gw)

    def attention(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        batch, tokens, dim = x.shape
        heads = self.cfg["num_heads"]
        head = dim // heads

        def split(name):
            y = self.linear(f"{pre}.attention.attention.{name}", x)
            return y.reshape(batch, tokens, heads, head)

        q, k, v = split("query"), split("key"), split("value")
        probs = torch.softmax(self.p.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head), dim=-1)
        out = self.p.einsum("bhqk,bkhd->bqhd", probs, v).reshape(batch, tokens, dim)
        return self.linear(f"{pre}.attention.output.dense", out)

    def ffn(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        if self.cfg["ffn"] == "swiglu":
            x1, x2 = self.linear(f"{pre}.mlp.weights_in", x).chunk(2, dim=-1)
            return self.linear(f"{pre}.mlp.weights_out", F.silu(x1) * x2)
        return self.linear(f"{pre}.mlp.fc2", F.gelu(self.linear(f"{pre}.mlp.fc1", x)))

    def __call__(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, 3, H, W] -> the last hidden state [B, 1 + h w, D]."""
        x = self.embed(pixels)
        for i in range(self.cfg["num_layers"]):
            pre = f"encoder.layer.{i}"
            x = x + self.w[f"{pre}.layer_scale1.lambda1"] * self.attention(
                pre, self.norm(f"{pre}.norm1", x))
            x = x + self.w[f"{pre}.layer_scale2.lambda1"] * self.ffn(
                pre, self.norm(f"{pre}.norm2", x))
        return self.norm("layernorm", x)

    def patch_grid(self, frames: torch.Tensor, block: int) -> torch.Tensor:
        """uint8 frames [T, H, W, 3] -> patch tokens [T, h, w, D], ``block``
        frames at a time."""
        p = self.cfg["patch_size"]
        out = []
        for i in range(0, frames.shape[0], block):
            pixels = preprocess(frames[i : i + block], p)
            tokens = self(pixels)[:, 1:]
            out.append(tokens.reshape(pixels.shape[0], pixels.shape[2] // p,
                                      pixels.shape[3] // p, -1))
        return torch.cat(out)
