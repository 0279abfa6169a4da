"""DINOv2-compatible Vision Transformer (port of ``tdspa/features/vit.py``).

Pre-LN blocks with layer scale, qkv-bias attention, the exact-erf GELU MLP
(tanh with ``gelu_approximate``), bicubic position-embedding interpolation
and a final LayerNorm that emits f32, as HF ``Dinov2Model`` computes them.
Parameter names and layouts are the flax tree's (``DenseGeneral`` kernels
``[in, H, Dh]``, ``output`` ``[H, Dh, out]``, the patch ``Conv`` kernel
``[p, p, 3, D]``), so ``tdspa_torch.infer.convert.params_from_flax`` carries
a JAX parameter tree across unchanged, and ``convert_hf_dinov2_params`` maps
an HF state_dict onto it.

Attention on CUDA tensors runs the maskless Hopper kernel
(``tdspa_torch/kernels/attention.py::vit_attention``, the counterpart of the
TPU's ``_flash_perhead``); on the CPU, or with ``use_fused=False``, it is the
JAX package's XLA path: q scaled in the compute dtype before the product,
f32 softmax.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from tdspa_torch.core.attention import Dense, DenseGeneral, masked_dot_product_attention
from tdspa_torch.core.layers import Conv, LayerNorm
from tdspa_torch.kernels.attention import vit_attention
from tdspa_torch.ops.resize import resize


class ViTConfig:
    """Shapes for dinov2-small/base/large/giant."""

    PRESETS = {
        "vits": dict(hidden_size=384, num_layers=12, num_heads=6),
        "vitb": dict(hidden_size=768, num_layers=12, num_heads=12),
        "vitl": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "vitg": dict(hidden_size=1536, num_layers=40, num_heads=24),
    }

    def __init__(
        self,
        hidden_size: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_ratio: int = 4,
        patch_size: int = 14,
        image_size: int = 518,
        layer_norm_eps: float = 1e-6,
        layerscale_value: float = 1.0,
    ):
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.patch_size = patch_size
        self.image_size = image_size
        self.layer_norm_eps = layer_norm_eps
        self.layerscale_value = layerscale_value

    @classmethod
    def preset(cls, name: str, **kwargs) -> "ViTConfig":
        return cls(**{**cls.PRESETS[name], **kwargs})


class _Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, dtype=torch.float32,
                 use_fused: bool = True, kernel_out_dtype=torch.float32, device="cpu"):
        super().__init__()
        head_dim = hidden_size // num_heads
        self.dtype, self.use_fused, self.kernel_out_dtype = dtype, use_fused, kernel_out_dtype
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((hidden_size,), (num_heads, head_dim), True,
                                               dtype, device))
        self.output = DenseGeneral((num_heads, head_dim), (hidden_size,), True, dtype, device)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B S H Dh]
        if self.use_fused and q.is_cuda:
            out = vit_attention(*(t.to(torch.bfloat16).contiguous() for t in (q, k, v)),
                                out_dtype=self.kernel_out_dtype)
            return self.output(out.to(self.dtype))
        return self.output(masked_dot_product_attention(q, k, v, compute_dtype=self.dtype))


class _Block(nn.Module):
    """Pre-LN block; ``residual_dtype`` is the residual stream's type (norm
    statistics stay f32), ``gelu_approximate`` swaps HF's erf GELU for tanh."""

    def __init__(self, config: ViTConfig, dtype=torch.float32, residual_dtype=torch.float32,
                 gelu_approximate: bool = False, use_fused: bool = True, device="cpu"):
        super().__init__()
        c = config
        self.residual_dtype = residual_dtype
        self.gelu = "tanh" if gelu_approximate else "none"
        self.layerscale_value = c.layerscale_value
        self.norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps, residual_dtype, device)
        self.attention = _Attention(c.hidden_size, c.num_heads, dtype, use_fused,
                                    kernel_out_dtype=residual_dtype, device=device)
        self.layer_scale1 = nn.Parameter(torch.empty(c.hidden_size, device=device))
        self.norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps, residual_dtype, device)
        self.fc1 = Dense(c.hidden_size, c.hidden_size * c.mlp_ratio, dtype, device)
        self.fc2 = Dense(c.hidden_size * c.mlp_ratio, c.hidden_size, dtype, device)
        self.layer_scale2 = nn.Parameter(torch.empty(c.hidden_size, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.layer_scale1.fill_(self.layerscale_value)
            self.layer_scale2.fill_(self.layerscale_value)

    def forward(self, x):
        rd = self.residual_dtype
        # The f32 layer-scale parameters are cast down rather than promoting
        # the residual back to f32.
        h = self.attention(self.norm1(x)) * self.layer_scale1.to(rd)
        x = x.to(rd) + h
        h = F.gelu(self.fc1(self.norm2(x)), approximate=self.gelu)
        h = self.fc2(h) * self.layer_scale2.to(rd)
        return x + h.to(rd)


def interpolate_pos_embed(pos_embed, new_height: int, new_width: int):
    """Bicubic-resize the patch position grid; the CLS slot passes through.

    pos_embed: [1, 1+S*S, D] -> [1, 1+new_h*new_w, D].
    """
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    side = int(round(patch_pos.shape[1] ** 0.5))
    dim = patch_pos.shape[-1]
    if (new_height, new_width) == (side, side):
        return pos_embed
    grid = resize(patch_pos.reshape(1, side, side, dim).float(), (new_height, new_width),
                  method="bicubic")
    return torch.cat([cls_pos, grid.reshape(1, new_height * new_width, dim)], dim=1)


class Dinov2(nn.Module):
    """DINOv2 encoder (counterpart of ``Dinov2Flax``): [B H W 3] -> tokens.

    ``forward`` returns the last hidden state [B, 1+hw, D] in f32 (CLS
    first), and with ``taps`` (block indices) also the outputs of those
    blocks in that order (in the residual dtype), which the depth estimator
    reads.
    """

    def __init__(self, config: ViTConfig, dtype=torch.float32, residual_dtype=torch.float32,
                 gelu_approximate: bool = False, use_fused: bool = True, device="cpu"):
        super().__init__()
        c = self.config = config
        p = c.patch_size
        native = c.image_size // p
        self.patch_embed = Conv(3, c.hidden_size, p, stride=p, dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.hidden_size, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, native * native + 1, c.hidden_size, device=device)
        )
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", _Block(c, dtype, residual_dtype, gelu_approximate,
                                                 use_fused, device))
        self.layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.cls_token.normal_(0.0, 1.0, generator=generator)
            self.pos_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, pixel_values, taps=()):
        x = self.patch_embed(pixel_values)  # [B hp wp D]
        batch, hp, wp, dim = x.shape
        cls = self.cls_token.expand(batch, 1, dim)
        x = torch.cat([cls, x.reshape(batch, hp * wp, dim).to(cls.dtype)], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, hp, wp)
        tapped = {}
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i in taps:
                tapped[i] = x
        out = self.layernorm(x)
        return (out, [tapped[i] for i in taps]) if taps else out

    def patch_grid(self, pixel_values):
        """[B H W 3] -> [B Hp Wp D] patch features (CLS dropped)."""
        tokens = self(pixel_values)
        batch, height, width, _ = pixel_values.shape
        p = self.config.patch_size
        return tokens[:, 1:].reshape(batch, height // p, width // p, self.config.hidden_size)


def convert_hf_dinov2_params(state_dict, config: ViTConfig) -> dict:
    """HF ``Dinov2Model`` torch state_dict -> the flax parameter tree (numpy)."""

    def t(name):
        return state_dict[name].detach().cpu().numpy()

    d, h = config.hidden_size, config.num_heads
    hd = d // h
    params: dict = {
        "cls_token": t("embeddings.cls_token"),
        "pos_embed": t("embeddings.position_embeddings"),
        "patch_embed": {
            # torch conv [out,in,kh,kw] -> flax [kh,kw,in,out]
            "kernel": t("embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
            "bias": t("embeddings.patch_embeddings.projection.bias"),
        },
        "layernorm": {"scale": t("layernorm.weight"), "bias": t("layernorm.bias")},
    }
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}"
        attn = f"{pre}.attention.attention"

        def qkv(name):
            w = t(f"{attn}.{name}.weight")  # [d, d] torch (out, in)
            b = t(f"{attn}.{name}.bias")
            return {"kernel": w.T.reshape(d, h, hd), "bias": b.reshape(h, hd)}

        out_w = t(f"{pre}.attention.output.dense.weight")  # [d, d]
        params[f"layer_{i}"] = {
            "norm1": {"scale": t(f"{pre}.norm1.weight"), "bias": t(f"{pre}.norm1.bias")},
            "norm2": {"scale": t(f"{pre}.norm2.weight"), "bias": t(f"{pre}.norm2.bias")},
            "attention": {
                "query": qkv("query"),
                "key": qkv("key"),
                "value": qkv("value"),
                "output": {
                    "kernel": out_w.T.reshape(h, hd, d),
                    "bias": t(f"{pre}.attention.output.dense.bias"),
                },
            },
            "layer_scale1": t(f"{pre}.layer_scale1.lambda1"),
            "layer_scale2": t(f"{pre}.layer_scale2.lambda1"),
            "fc1": {"kernel": t(f"{pre}.mlp.fc1.weight").T, "bias": t(f"{pre}.mlp.fc1.bias")},
            "fc2": {"kernel": t(f"{pre}.mlp.fc2.weight").T, "bias": t(f"{pre}.mlp.fc2.bias")},
        }
    return params
