"""DINOv2-compatible Vision Transformer (port of ``tdspa/features/vit.py``).

Pre-LN blocks with layer scale, qkv-bias attention, the exact-erf GELU MLP
(tanh with ``gelu_approximate``) or, for ViT-g/14, the SwiGLU FFN
(``ViTConfig.ffn``), bicubic position-embedding interpolation and a final
LayerNorm that emits f32, as HF ``Dinov2Model`` computes them. The position
table is resized as ``jax.image.resize`` does (antialiased Keys cubic,
a = -0.5; the JAX package's choice, kept for ViT-S/B/L so that they stay the
JAX package's answer) or, with ``pos_resize="hf"`` (the ``vitg`` preset: the
JAX package has no SwiGLU, and ViT-g/14 is held to HF's plain reference), as
HF does (``F.interpolate`` bicubic, a = -0.75, no antialiasing).
Parameter names and layouts are the flax tree's (``DenseGeneral`` kernels
``[in, H, Dh]``, ``output`` ``[H, Dh, out]``, the patch ``Conv`` kernel
``[p, p, 3, D]``), so ``tdspa_torch.infer.convert.params_from_flax`` carries
a JAX parameter tree across unchanged, and ``convert_hf_dinov2_params`` maps
an HF state_dict onto it.

Attention on CUDA tensors runs the maskless Hopper kernel
(``tdspa_torch/kernels/attention.py::vit_attention``, the counterpart of the
TPU's ``_flash_perhead``); on the CPU, or with ``use_fused=False``, it is the
JAX package's XLA path: q scaled in the compute dtype before the product,
f32 softmax. The blocks' norms, bias adds, layer scales, residual sums and
SwiGLU gate, and the final norm, run ``kernels/vit_block.py`` (its kernels on
CUDA tensors, its plain versions, the eager chain, on CPU tensors).
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from tdspa_torch.core.attention import Dense, DenseGeneral, masked_dot_product_attention
from tdspa_torch.core.layers import Conv, LayerNorm
from tdspa_torch.kernels.attention import vit_attention
from tdspa_torch.kernels.vit_block import swiglu_gate, vit_residual_norm
from tdspa_torch.ops.resize import resize, resize_torch_bicubic
from tdspa_torch.utils.profiling import span

FFNS = ("mlp", "swiglu")
POS_RESIZES = ("jax", "hf")


class ViTConfig:
    """Shapes for dinov2-small/base/large/giant. ``ffn`` is the block's
    feed-forward: ``mlp`` (fc1, GELU, fc2) or ``swiglu`` (ViT-g/14's
    ``SwiGLUFFNFused``); ``pos_resize`` the position table's resize (module
    docstring)."""

    PRESETS = {
        "vits": dict(hidden_size=384, num_layers=12, num_heads=6),
        "vitb": dict(hidden_size=768, num_layers=12, num_heads=12),
        "vitl": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "vitg": dict(hidden_size=1536, num_layers=40, num_heads=24, ffn="swiglu",
                     pos_resize="hf"),
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
        ffn: str = "mlp",
        pos_resize: str = "jax",
    ):
        if ffn not in FFNS or pos_resize not in POS_RESIZES:
            raise ValueError(f"ffn={ffn!r} must be one of {FFNS} and pos_resize={pos_resize!r} "
                             f"one of {POS_RESIZES}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.patch_size = patch_size
        self.image_size = image_size
        self.layer_norm_eps = layer_norm_eps
        self.layerscale_value = layerscale_value
        self.ffn = ffn
        self.pos_resize = pos_resize

    @property
    def ffn_hidden_size(self) -> int:
        """The FFN's hidden width: ``mlp_ratio`` x the model's for the MLP; for
        SwiGLU two thirds of that, rounded up to a multiple of 8 (4096 at
        1536), as ``SwiGLUFFNFused`` sizes it."""
        hidden = self.hidden_size * self.mlp_ratio
        return hidden if self.ffn == "mlp" else (int(hidden * 2 / 3) + 7) // 8 * 8

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

    def heads(self, x):
        """The attention's heads [B S H Dh], before the output projection. The
        kernel writes bf16 where the compute dtype or ``kernel_out_dtype`` is
        bf16: its f32 value rounded once, as the cast after an f32 output
        rounded it."""
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B S H Dh]
        if self.use_fused and q.is_cuda:
            out_dtype = (torch.bfloat16 if torch.bfloat16 in (self.dtype, self.kernel_out_dtype)
                         else torch.float32)
            out = vit_attention(*(t.to(torch.bfloat16).contiguous() for t in (q, k, v)),
                                out_dtype=out_dtype)
            return out.to(self.dtype)
        return masked_dot_product_attention(q, k, v, compute_dtype=self.dtype)

    def forward(self, x):
        return self.output(self.heads(x))


def _unbiased(dense: DenseGeneral, x):
    """``dense(x)`` without its bias, which a ``vit_residual_norm`` or
    ``swiglu_gate`` launch adds (``dense``'s output shape is one axis)."""
    n_in = math.prod(dense.in_shape)
    lead = x.shape[: x.dim() - len(dense.in_shape)]
    return x.to(dense.dtype).reshape(lead + (n_in,)) @ dense.kernel.to(dense.dtype).reshape(
        n_in, -1)


def _norm_args(norm: LayerNorm):
    return norm.scale, norm.bias, norm.eps


class _Block(nn.Module):
    """Pre-LN block; ``residual_dtype`` is the residual stream's type (norm
    statistics stay f32), ``gelu_approximate`` swaps HF's erf GELU for tanh
    (the MLP's). The SwiGLU FFN is ``weights_out(silu(x1) * x2)`` with
    ``x1, x2`` the halves of ``weights_in(x)``, in the compute dtype.

    A call is three ``vit_residual_norm`` launches: norm1, written in the
    compute dtype the projections read; the attention's output bias, layer
    scale and residual with norm2, in one pass; the FFN's output bias, layer
    scale and residual. The output projection and the FFN's last GEMM run
    without their bias, which those launches add; the SwiGLU's gate is one
    ``swiglu_gate`` launch. An f32 compute dtype over a bf16 stream widens the
    stream to f32 inside the block, which no kernel takes: that block runs
    the eager chain (``_forward_widening``).
    Spans: ``tdspa.vit.attention`` (norm1, attention, then the launch that
    adds its residual and computes norm2) and ``tdspa.vit.ffn`` (FFN, layer
    scale, residual)."""

    def __init__(self, config: ViTConfig, dtype=torch.float32, residual_dtype=torch.float32,
                 gelu_approximate: bool = False, use_fused: bool = True, device="cpu"):
        super().__init__()
        c = config
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.gelu = "tanh" if gelu_approximate else "none"
        self.layerscale_value = c.layerscale_value
        self.norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps, residual_dtype, device)
        self.attention = _Attention(c.hidden_size, c.num_heads, dtype, use_fused,
                                    kernel_out_dtype=residual_dtype, device=device)
        self.layer_scale1 = nn.Parameter(torch.empty(c.hidden_size, device=device))
        self.norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps, residual_dtype, device)
        self.swiglu = c.ffn == "swiglu"
        hidden = c.ffn_hidden_size
        if self.swiglu:
            self.weights_in = Dense(c.hidden_size, 2 * hidden, dtype, device)
            self.weights_out = Dense(hidden, c.hidden_size, dtype, device)
        else:
            self.fc1 = Dense(c.hidden_size, hidden, dtype, device)
            self.fc2 = Dense(hidden, c.hidden_size, dtype, device)
        self.layer_scale2 = nn.Parameter(torch.empty(c.hidden_size, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.layer_scale1.fill_(self.layerscale_value)
            self.layer_scale2.fill_(self.layerscale_value)

    @property
    def ffn_out(self) -> DenseGeneral:
        return self.weights_out if self.swiglu else self.fc2

    def ffn(self, x):
        """The FFN's output without ``ffn_out``'s bias (the residual launch
        adds it)."""
        if self.swiglu:
            return _unbiased(self.weights_out,
                             swiglu_gate(_unbiased(self.weights_in, x), self.weights_in.bias))
        return _unbiased(self.fc2, F.gelu(self.fc1(x), approximate=self.gelu))

    def forward(self, x):
        rd = self.residual_dtype
        if torch.promote_types(self.dtype, rd) != rd:
            return self._forward_widening(x)
        # The f32 layer-scale parameters are cast to the stream's dtype rather
        # than promoting it back to f32.
        with span("tdspa.vit.attention"):
            h = vit_residual_norm(x, norm=_norm_args(self.norm1), out_dtype=self.dtype)
            h = _unbiased(self.attention.output, self.attention.heads(h))
            x, h = vit_residual_norm(x.to(rd), (h, self.attention.output.bias, self.layer_scale1),
                                     _norm_args(self.norm2), self.dtype)
        with span("tdspa.vit.ffn"):
            return vit_residual_norm(x, (self.ffn(h), self.ffn_out.bias, self.layer_scale2))

    def _forward_widening(self, x):
        """The eager chain of an f32 compute dtype over a bf16 stream: the
        attention's residual sum takes the f32 product unrounded and leaves
        the stream f32; the FFN's rounds its product to bf16."""
        rd = self.residual_dtype
        with span("tdspa.vit.attention"):
            h = self.attention(self.norm1(x)) * self.layer_scale1.to(rd)
            x = x.to(rd) + h
        with span("tdspa.vit.ffn"):
            h = self.ffn(self.norm2(x)) + self.ffn_out.bias.to(self.dtype)
            return x + (h * self.layer_scale2.to(rd)).to(rd)


def interpolate_pos_embed(pos_embed, new_height: int, new_width: int, mode: str = "jax"):
    """Bicubic-resize the patch position grid; the CLS slot passes through.
    ``mode`` is ``ViTConfig.pos_resize``.

    pos_embed: [1, 1+S*S, D] -> [1, 1+new_h*new_w, D].
    """
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    side = int(round(patch_pos.shape[1] ** 0.5))
    dim = patch_pos.shape[-1]
    if (new_height, new_width) == (side, side):
        return pos_embed
    grid = patch_pos.reshape(1, side, side, dim).float()
    if mode == "hf":
        grid = resize_torch_bicubic(grid, (new_height, new_width))
    else:
        grid = resize(grid, (new_height, new_width), method="bicubic")
    return torch.cat([cls_pos, grid.reshape(1, new_height * new_width, dim)], dim=1)


class Dinov2(nn.Module):
    """DINOv2 encoder (counterpart of ``Dinov2Flax``): [B H W 3] -> tokens.
    Spans: ``tdspa.vit.embed`` (patch embedding, CLS, position table), the
    blocks' and ``tdspa.vit.final_norm``.

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
        with span("tdspa.vit.embed"):
            x = self.patch_embed(pixel_values)  # [B hp wp D]
            batch, hp, wp, dim = x.shape
            cls = self.cls_token.expand(batch, 1, dim)
            x = torch.cat([cls, x.reshape(batch, hp * wp, dim).to(cls.dtype)], dim=1)
            x = x + interpolate_pos_embed(self.pos_embed, hp, wp, self.config.pos_resize)
        tapped = {}
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i in taps:
                tapped[i] = x
        with span("tdspa.vit.final_norm"):
            out = vit_residual_norm(x, norm=_norm_args(self.layernorm), out_dtype=torch.float32)
        return (out, [tapped[i] for i in taps]) if taps else out

    def patch_grid(self, pixel_values):
        """[B H W 3] -> [B Hp Wp D] patch features (CLS dropped)."""
        tokens = self(pixel_values)
        batch, height, width, _ = pixel_values.shape
        p = self.config.patch_size
        return tokens[:, 1:].reshape(batch, height // p, width // p, self.config.hidden_size)


def convert_hf_dinov2_params(state_dict, config: ViTConfig) -> dict:
    """HF ``Dinov2Model`` torch state_dict -> the flax parameter tree (numpy).
    The FFN's weights are ``mlp.fc1``/``mlp.fc2`` or, for ``ffn="swiglu"``,
    ``mlp.weights_in``/``mlp.weights_out`` (a missing one raises
    ``KeyError``); the unused ``embeddings.mask_token`` is not read."""

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
        }
        ffn = ("weights_in", "weights_out") if config.ffn == "swiglu" else ("fc1", "fc2")
        for name in ffn:
            params[f"layer_{i}"][name] = {"kernel": t(f"{pre}.mlp.{name}.weight").T,
                                          "bias": t(f"{pre}.mlp.{name}.bias")}
    return params
