"""QK-norm parallel-path transformer stack (port of ``tdspa/core/attention.py``).

* ``QKNormAttention``: bias-free Q/K/V projections, RMSNorm on the projected
  query and key heads, a biased output projection over the flattened heads.
* ``ParallelTransformerBlock``: one shared pre-LayerNorm; self- and
  (optional) cross-attention from the same normalized queries, both added to
  the raw residual; the GELU MLP follows its own LayerNorm. Cross-attention
  K/V come from the unnormalized ``inputs_kv``.
* ``TransformerStack``: ``layer_{i}`` blocks and a final bias-free
  LayerNorm ``norm_encoder``.

Parameter names and layouts are the flax tree's (``DenseGeneral`` kernels
``[in, H, Dh]``, ``dense_out`` ``[H, Dh, out]``, ``Dense`` kernels
``[in, out]``), so ``tdspa_torch.infer.convert`` maps checkpoints by name.
Numerics follow flax: a layer with ``dtype`` casts both its input and its
f32 parameters to ``dtype``; norms take f32 statistics with eps 1e-6 and
return ``dtype`` (a block's two pre-projection LayerNorms return the compute
dtype at once where that rounds to the same bits, ``_norm_dtype``; where
autograd records, the query norm gives each of its readers a tensor of its
own, and its backward sums their cotangents in f32); ``gelu`` is the tanh
approximation. Each norm is one launch of ``csrc/norm.cu`` on CUDA tensors
(``kernels/norm.py``).

Two inference knobs, as in the JAX package: ``quantize`` swaps the
projections and the MLP for the dynamic-int8 layers of ``core/quant.py``
(same parameters); ``fused_block`` runs an unmasked self-attention block
through the fused block kernel (``kernels/block.py``) when the kernel takes
its shapes, and never under ``quantize``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from tdspa_torch.kernels.attention import fused_attention_fn, fused_masked_attention
from tdspa_torch.kernels.block import fused_transformer_block, kernel_takes
from tdspa_torch.kernels.build import records
from tdspa_torch.kernels.norm import row_norm, row_norm_shared

_FILL = torch.finfo(torch.float32).min


def lecun_normal_(param: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(param, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class DenseGeneral(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the trailing ``in_shape``."""

    def __init__(self, in_shape, out_shape, use_bias: bool, dtype, device):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape, device=device))
        self.bias = (
            nn.Parameter(torch.empty(self.out_shape, device=device)) if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        w = self.kernel.to(self.dtype).reshape(n_in, n_out)
        y = x.to(self.dtype).reshape(lead + (n_in,)) @ w
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(n_out)
        return y.reshape(lead + self.out_shape)


def Dense(in_features: int, out_features: int, dtype, device) -> DenseGeneral:
    return DenseGeneral((in_features,), (out_features,), True, dtype, device)


class _Norm(nn.Module):
    """flax ``LayerNorm(use_bias=False)`` (``centered``) or ``RMSNorm``: one
    launch of ``csrc/norm.cu`` on CUDA tensors (``kernels/norm.py``), the
    eager chain on CPU tensors."""

    def __init__(self, width: int, centered: bool, dtype, device):
        super().__init__()
        self.centered = centered
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(width, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, out_dtype=None, readers=None):
        """The norm in ``out_dtype`` (the module's dtype when None); with
        ``readers``, a tuple of that many tensors over one output, one for
        each projection that reads it (``kernels/norm.py::row_norm_shared``)."""
        dtype = self.dtype if out_dtype is None else out_dtype
        if readers is None:
            return row_norm(x, self.scale, self.centered, dtype)
        return row_norm_shared(x, self.scale, self.centered, dtype, readers)


def LayerNorm(width, dtype, device) -> _Norm:
    return _Norm(width, True, dtype, device)


def RMSNorm(width, dtype, device) -> _Norm:
    return _Norm(width, False, dtype, device)


def masked_dot_product_attention(query, key, value, mask=None, compute_dtype=torch.float32):
    """Multi-head attention core: compute-dtype products, f32 softmax.

    query [*B Q H D], key/value [*B K H D], mask broadcastable to
    [*B H Q K] (nonzero = attend). A fully masked query row gets uniform
    weights: the mean of the values.
    """
    depth = query.shape[-1]
    # sqrt(D) rounded to the compute dtype, as the JAX core divides by it.
    root = float(torch.tensor(math.sqrt(depth), dtype=torch.float32).to(compute_dtype))
    q = query.to(compute_dtype) / root
    k = key.to(compute_dtype)
    v = value.to(compute_dtype)
    # Products of compute-dtype values accumulated in f32.
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    if mask is not None:
        logits = torch.where(mask.bool(), logits, _FILL)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(compute_dtype).float(), v.float())


def _fused_attention_applicable(q, k, mask) -> bool:
    """Kernel path: CUDA tensors, a key-only mask, matching batch dims."""
    if not q.is_cuda:
        return False
    if mask is not None and (mask.shape[-2] != 1 or mask.shape[-3] != 1):
        return False  # not a pure key (query-broadcast) mask
    return q.shape[:-3] == k.shape[:-3]


def _fused_attention(q, k, v, mask, out_dtype):
    """Flatten leading batch dims and launch the fused kernel: with f32 output
    through the differentiable ``fused_attention_fn`` (the training path), with
    bf16 output (bf16-residual inference) straight, as JAX does."""
    lead = q.shape[:-3]
    s, h, d = q.shape[-3:]
    kv = k.shape[-3]
    key_mask = None
    if mask is not None:
        key_mask = mask[..., 0, 0, :].expand(lead + (kv,)).reshape(-1, kv)

    def flat(x, n):
        return x.to(torch.bfloat16).reshape(-1, n, h, d).contiguous()

    if out_dtype == torch.float32:
        out = fused_attention_fn(flat(q, s), flat(k, kv), flat(v, kv), key_mask)
    else:
        out = fused_masked_attention(
            flat(q, s), flat(k, kv), flat(v, kv), key_mask, out_dtype=out_dtype
        )
    return out.reshape(lead + (s, h, d))


class QKNormAttention(nn.Module):
    """Multi-head attention with RMSNorm on the projected Q/K heads."""

    def __init__(self, q_width: int, kv_width: int, num_heads: int, qk_size: int,
                 v_size: int | None = None, dtype=torch.float32, use_fused: bool = False,
                 residual_dtype=torch.float32, quantize: bool = False, device="cpu"):
        super().__init__()
        v_size = qk_size if v_size is None else v_size
        if qk_size % num_heads:
            raise ValueError(f"{num_heads=} must divide {qk_size=}.")
        if v_size % num_heads:
            raise ValueError(f"{num_heads=} must divide {v_size=}.")
        head_qk, head_v = qk_size // num_heads, v_size // num_heads
        self.dtype, self.use_fused, self.residual_dtype = dtype, use_fused, residual_dtype
        if quantize:
            from tdspa_torch.core.quant import QuantDenseGeneral

            def dense(i, o, bias):
                return QuantDenseGeneral(i, o, bias, device)
        else:
            def dense(i, o, bias):
                return DenseGeneral(i, o, bias, dtype, device)
        self.dense_query = dense((q_width,), (num_heads, head_qk), False)
        self.dense_key = dense((kv_width,), (num_heads, head_qk), False)
        self.norm_query = RMSNorm(head_qk, dtype, device)
        self.norm_key = RMSNorm(head_qk, dtype, device)
        self.dense_value = dense((kv_width,), (num_heads, head_v), False)
        self.dense_out = dense((num_heads, head_v), (q_width,), True)

    def forward(self, inputs_q, inputs_kv, mask=None, inputs_v=None):
        """``inputs_v``, where given, is what the value projection reads in
        place of ``inputs_kv``: the same values as a tensor of its own."""
        query = self.norm_query(self.dense_query(inputs_q))
        key = self.norm_key(self.dense_key(inputs_kv))
        value = self.dense_value(inputs_kv if inputs_v is None else inputs_v)
        if self.use_fused and _fused_attention_applicable(query, key, mask):
            x = _fused_attention(query, key, value, mask, out_dtype=self.residual_dtype)
        else:
            x = masked_dot_product_attention(query, key, value, mask, compute_dtype=self.dtype)
        return self.dense_out(x).to(self.residual_dtype)


def _fused_block_applicable(block, queries, inputs_kv, qq_mask, qk_mask) -> bool:
    """Fused-block path: self-attention only, no masks, not quantised, and
    shapes the block kernel takes (its stated limits stand in for the JAX
    gate's VMEM-fit test). The same decision on every device: the CPU runs
    the kernel's plain version."""
    if inputs_kv is not None or qq_mask is not None or qk_mask is not None or block.quantize:
        return False
    return math.prod(queries.shape[:-2]) > 0 and kernel_takes(
        queries.shape[-2], queries.shape[-1], block.num_heads, block.head_dim, block.mlp_size
    )


class ParallelTransformerBlock(nn.Module):
    """Pre-LN block with parallel self- + cross-attention into one residual."""

    def __init__(self, width: int, mlp_size: int, num_heads: int, qkv_size: int,
                 kv_width: int | None = None, dtype=torch.float32, use_fused: bool = False,
                 residual_dtype=torch.float32, quantize: bool = False,
                 fused_block: bool = False, device="cpu"):
        super().__init__()
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.num_heads, self.head_dim, self.mlp_size = num_heads, qkv_size // num_heads, mlp_size
        self.quantize, self.fused_block = quantize, fused_block
        attn = dict(num_heads=num_heads, qk_size=qkv_size, dtype=dtype, use_fused=use_fused,
                    residual_dtype=residual_dtype, quantize=quantize, device=device)
        self.norm_q = LayerNorm(width, residual_dtype, device)
        self.self_att = QKNormAttention(width, width, **attn)
        self.cross_att = QKNormAttention(width, kv_width, **attn) if kv_width else None
        self.norm_attn = LayerNorm(width, residual_dtype, device)
        if quantize:
            from tdspa_torch.core.quant import QuantDense

            self.MLP_in = QuantDense(width, mlp_size, device)
            self.MLP_out = QuantDense(mlp_size, width, device)
        else:
            self.MLP_in = Dense(width, mlp_size, dtype, device)
            self.MLP_out = Dense(mlp_size, width, dtype, device)

    def _norm_dtype(self):
        """The dtype ``norm_q`` and ``norm_attn`` write. Their only readers are
        projections that round to the compute dtype, so with an f32 residual
        the norms write that dtype at once: the same bits, rounded once. Not
        under ``quantize`` (the int8 layers quantise the f32 values). None
        keeps the norms' own dtype."""
        if self.residual_dtype != torch.float32 or self.quantize:
            return None
        return self.dtype

    def forward(self, queries, inputs_kv=None, qq_mask=None, qk_mask=None):
        if self.fused_block and _fused_block_applicable(
            self, queries, inputs_kv, qq_mask, qk_mask
        ):
            return fused_transformer_block(queries, self, self.num_heads,
                                           out_dtype=self.residual_dtype)
        norm_dtype = self._norm_dtype()
        if norm_dtype is not None and records(queries, self.norm_q.scale):
            # One tensor a projection, so that autograd never adds their
            # compute-dtype cotangents: the norm's backward sums them in f32.
            q_in, k_in, v_in, *cross_in = self.norm_q(queries, norm_dtype,
                                                      3 if inputs_kv is None else 4)
        else:
            q_in = k_in = v_in = self.norm_q(queries, norm_dtype)
            cross_in = [q_in]
        attn_out = queries.to(self.residual_dtype) + self.self_att(
            q_in, k_in, qq_mask, inputs_v=v_in
        )
        if inputs_kv is not None:
            attn_out = attn_out + self.cross_att(cross_in[0], inputs_kv, qk_mask)
        h = F.gelu(self.MLP_in(self.norm_attn(attn_out, norm_dtype)), approximate="tanh")
        return attn_out + self.MLP_out(h).to(self.residual_dtype)


class TransformerStack(nn.Module):
    """``num_layers`` ``ParallelTransformerBlock``s + final LayerNorm.

    ``qq_mask`` gates self-attention, ``qk_mask`` cross-attention to
    ``inputs_kv`` (which exists only when ``kv_width`` is given). A mask whose
    rank equals its operand's gets a broadcast head axis inserted.
    """

    def __init__(self, width: int, qkv_size: int, num_heads: int, mlp_size: int,
                 num_layers: int, kv_width: int | None = None, dtype=torch.float32,
                 use_fused: bool = False, residual_dtype=torch.float32,
                 quantize: bool = False, fused_block: bool = False, device="cpu"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ParallelTransformerBlock(
                width, mlp_size, num_heads, qkv_size, kv_width=kv_width, dtype=dtype,
                use_fused=use_fused, residual_dtype=residual_dtype, quantize=quantize,
                fused_block=fused_block, device=device,
            ))
        self.norm_encoder = LayerNorm(width, residual_dtype, device)

    def forward(self, queries, inputs_kv=None, qk_mask=None, qq_mask=None):
        if qk_mask is not None and inputs_kv is not None and qk_mask.dim() == inputs_kv.dim():
            qk_mask = qk_mask[..., None, :, :]
        if qq_mask is not None and qq_mask.dim() == queries.dim():
            qq_mask = qq_mask[..., None, :, :]
        for i in range(self.num_layers):
            queries = getattr(self, f"layer_{i}")(
                queries, inputs_kv=inputs_kv, qq_mask=qq_mask, qk_mask=qk_mask
            )
        return self.norm_encoder(queries)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` as flax would (same laws)."""
    for sub in module.modules():
        if sub is not module and hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)
