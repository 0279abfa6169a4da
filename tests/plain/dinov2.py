"""Plain DINOv2 forward in float32 PyTorch: the test suite's reference for
the port's ViT (``tdspa_torch/features/vit.py``), with either feed-forward
(the GELU MLP of ViT-S/B/L, the SwiGLU of ViT-g/14).

Written from HF ``Dinov2Model`` (``transformers/models/dinov2``) and
``facebookresearch/dinov2`` (``vision_transformer.py::vit_giant2``,
``layers/swiglu_ffn.py::SwiGLUFFNFused``). Weights are read under the
published checkpoint's ``state_dict`` names and layouts (``nn.Linear``
weights [out, in], the patch ``Conv2d`` [D, 3, p, p]) and the configuration
under ``Dinov2Config``'s keys, so nothing here is named or laid out as the
port's modules are. It imports nothing of the port, of the JAX package or of
JAX.

The function: pixels [B, 3, H, W] -> patch embedding (a p x p convolution of
stride p), the CLS token first, plus the position table (CLS slot, then the
native grid resized to the image's patch grid); pre-LN blocks
``x + ls1 * attn(norm1(x))``, ``x + ls2 * ffn(norm2(x))`` with qkv-bias
multi-head attention (softmax of q k^T / sqrt(head)); the MLP ``fc2(gelu(fc1
x))`` (exact erf GELU) or the SwiGLU ``weights_out(silu(x1) * x2)`` with
``x1, x2 = chunk(weights_in(x), 2)`` and hidden width
``(int(4 D * 2 / 3) + 7) // 8 * 8``; a final LayerNorm. Returns the last
hidden state [B, 1 + h w, D].

Departures from HF, each deliberate:
* ``embeddings.mask_token`` is not read (masked image modelling in
  pre-training; HF's forward without ``bool_masked_pos`` never uses it);
* evaluation mode: no dropout or drop path; no pooler output;
* the position grid is resized as HF resizes it (``F.interpolate`` to the
  patch grid's size, bicubic, a = -0.75, ``align_corners=False``, no
  antialiasing; the identity at the native grid); the facebookresearch code
  passes scale factors ``(h + 0.1) / sqrt(N)`` instead, which places the
  samples slightly differently. The port resizes so only for ViT-g/14
  (``ViTConfig.pos_resize="hf"``); its ViT-S/B/L follow the JAX package's
  antialiased resize, so an interpolated table is compared here only under
  ``pos_resize="hf"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def swiglu_hidden(cfg: dict) -> int:
    return (int(int(cfg["hidden_size"] * cfg["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8


def state_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """name -> shape of every tensor the forward reads, as in the checkpoint."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    native = cfg["image_size"] // p
    out = {
        "embeddings.cls_token": (1, 1, d),
        "embeddings.position_embeddings": (1, native * native + 1, d),
        "embeddings.patch_embeddings.projection.weight": (d, 3, p, p),
        "embeddings.patch_embeddings.projection.bias": (d,),
    }
    if cfg["use_swiglu_ffn"]:
        h = swiglu_hidden(cfg)
        ffn = {"weights_in": (2 * h, d), "weights_out": (d, h)}
    else:
        h = int(d * cfg["mlp_ratio"])
        ffn = {"fc1": (h, d), "fc2": (d, h)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}"
        for norm in ("norm1", "norm2"):
            out[f"{pre}.{norm}.weight"] = out[f"{pre}.{norm}.bias"] = (d,)
        for name in ("query", "key", "value"):
            out[f"{pre}.attention.attention.{name}.weight"] = (d, d)
            out[f"{pre}.attention.attention.{name}.bias"] = (d,)
        out[f"{pre}.attention.output.dense.weight"] = (d, d)
        out[f"{pre}.attention.output.dense.bias"] = (d,)
        out[f"{pre}.layer_scale1.lambda1"] = out[f"{pre}.layer_scale2.lambda1"] = (d,)
        for name, shape in ffn.items():
            out[f"{pre}.mlp.{name}.weight"] = shape
            out[f"{pre}.mlp.{name}.bias"] = (shape[0],)
    out["layernorm.weight"] = out["layernorm.bias"] = (d,)
    return out


def _linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[f"{name}.weight"].float().T + w[f"{name}.bias"].float()


def _norm(w: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"].float(), w[f"{name}.bias"].float(),
                        eps)


def position_table(w: dict, grid_h: int, grid_w: int) -> torch.Tensor:
    """[1, 1 + grid_h grid_w, D]: the CLS slot, then the grid resized as HF does."""
    table = w["embeddings.position_embeddings"].float()
    side = math.isqrt(table.shape[1] - 1)
    if (grid_h, grid_w) == (side, side):
        return table
    dim = table.shape[-1]
    grid = table[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(grid_h, grid_w), mode="bicubic", align_corners=False)
    return torch.cat([table[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)


def embed(w: dict, pixels: torch.Tensor, cfg: dict) -> torch.Tensor:
    p = cfg["patch_size"]
    x = F.conv2d(pixels.float(), w["embeddings.patch_embeddings.projection.weight"].float(),
                 w["embeddings.patch_embeddings.projection.bias"].float(), stride=p)
    batch, dim, grid_h, grid_w = x.shape
    x = x.flatten(2).transpose(1, 2)
    cls = w["embeddings.cls_token"].float().expand(batch, 1, dim)
    return torch.cat([cls, x], dim=1) + position_table(w, grid_h, grid_w)


def attention(w: dict, pre: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    batch, tokens, dim = x.shape
    head = dim // heads

    def split(name):
        y = _linear(w, f"{pre}.attention.attention.{name}", x)
        return y.reshape(batch, tokens, heads, head).transpose(1, 2)

    q, k, v = split("query"), split("key"), split("value")
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(head), dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(batch, tokens, dim)
    return _linear(w, f"{pre}.attention.output.dense", out)


def ffn(w: dict, pre: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    if cfg["use_swiglu_ffn"]:
        x1, x2 = _linear(w, f"{pre}.mlp.weights_in", x).chunk(2, dim=-1)
        return _linear(w, f"{pre}.mlp.weights_out", F.silu(x1) * x2)
    return _linear(w, f"{pre}.mlp.fc2", F.gelu(_linear(w, f"{pre}.mlp.fc1", x)))


def block(w: dict, i: int, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    pre, eps = f"encoder.layer.{i}", cfg["layer_norm_eps"]
    x = x + w[f"{pre}.layer_scale1.lambda1"].float() * attention(
        w, pre, _norm(w, f"{pre}.norm1", x, eps), cfg["num_attention_heads"])
    return x + w[f"{pre}.layer_scale2.lambda1"].float() * ffn(
        w, pre, _norm(w, f"{pre}.norm2", x, eps), cfg)


def forward(w: dict, pixels: torch.Tensor, cfg: dict) -> torch.Tensor:
    """pixels [B, 3, H, W] (H, W multiples of the patch) -> [B, 1 + h w, D] f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = embed(w, pixels, cfg)
    for i in range(cfg["num_hidden_layers"]):
        x = block(w, i, x, cfg)
    return _norm(w, "layernorm", x, cfg["layer_norm_eps"])
