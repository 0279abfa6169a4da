"""One unmasked self-attention transformer block: CUDA kernel wrapper + its
plain version.

Replaces the TPU kernel ``tdspa/kernels/block.py::_block_forward`` (body
``_block_kernel``): one whole ``ParallelTransformerBlock`` layer without a
mask or cross-attention,

    ln1 = LayerNorm(x) * g1                             (x rounded to bf16 first)
    q, k = RMSNorm_head(ln1 @ Wq) * sq, RMSNorm_head(ln1 @ Wk) * sk;  v = ln1 @ Wv
    att = softmax(q k^T * Dh^-1/2) v                    (P normalised, then bf16)
    y   = x + att @ Wo + bo
    out = y + GELU_tanh(LayerNorm(y) * g2 @ W1 + b1) @ W2 + b2

with every operand (weights, norm scales, biases) rounded to bf16, bf16
products with f32 accumulation, two-pass f32 LayerNorm statistics, and f32
residual sums. The TPU body keeps a whole item and the layer's weights in
VMEM; an H100 SM holds 228 KB of shared memory, less than one readout item
(129 x 1280 bf16 is 330 KB). So ``tdspa_torch/csrc/block.cu`` runs the layer
as ``KERNELS_PER_CALL`` launches of its own kernels (``STAGES``): a streaming
LayerNorm (rows held in registers), a Q/K/V GEMM whose N tile holds whole
heads so that the RMSNorm sees each head's row, an attention stage that
loads q, k and v of each (item, head) once with TMA and keeps every logit of
a row in registers (``attention_plan``), the out-projection GEMM with bias
and residual, LayerNorm, the MLP GEMMs with bias and GELU or bias and
residual. The four GEMMs are persistent TMA + ``wgmma`` kernels: the Q/K/V
one cooperative, the other three ping-pong (each consumer warpgroup its own
tile, the residual loaded by TMA under the main loop). One wrapper call
counts as one block launch (``fused_transformer_block.launches``), made
through the custom op ``tdspa::fused_transformer_block`` (``kernels/ops.py``),
which takes the layer's parameters and caches their flattened operands.

The kernel takes a head width in ``HEAD_DIMS``, at most ``MAX_SEQ`` tokens
and widths that are multiples of 8 (``kernel_takes``); the model routes a
block to it only then (``core/attention.py``). CUDA tensors launch it or
raise; CPU tensors run ``block_reference``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import forward_only, on_cuda, records

HEAD_DIMS = (32, 64, 96, 128)
MAX_SEQ = 256  # all keys of an (item, head) in shared memory, their logits in registers
STAGES = ("ln1", "qkv", "attention", "out_proj", "ln2", "mlp_in", "mlp_out")  # one CUDA kernel each
KERNELS_PER_CALL = len(STAGES)
ALL_STAGES = (1 << KERNELS_PER_CALL) - 1
NORM_EPS = 1e-6
OPERANDS = ("g1", "wqkv_t", "sq", "sk", "wo_t", "bo", "g2", "w1_t", "b1", "w2_t", "b2")


# csrc/block.cu's attention stage (block_attention_kernel): warpgroups of 64
# query rows (three up to 192 keys and heads of 96, else two), 64-key tiles,
# 32-column boxes of 64-byte rows.
ATTENTION_CONSUMERS = 3
KEY_TILE = 64
SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


def attention_plan(items: int, seq: int, heads: int, head_dim: int, sms: int) -> dict:
    """How ``csrc/block.cu``'s attention stage divides one call.

    Work items are (item, head), walked by ``grid`` persistent blocks; each
    loads its q, k and v once (``kv_loads`` per work item) into one of
    ``buffers`` buffers of ``smem_bytes`` in all. The ``query_slabs`` 64-row
    slabs go to the ``warpgroups`` in turn (``slabs_per_warpgroup``), and
    every row's ``key_tiles`` x 64 logits stay in registers.
    """
    key_tiles = -(-seq // KEY_TILE)
    tile = head_dim // 32 * (KEY_TILE * key_tiles) * 64  # q, k or v: boxes x rows x 64 B
    item = 3 * tile + 3 * 8  # the tiles and three mbarriers
    buffers = 2 if 1024 + 2 * item <= SMEM_LIMIT else 1
    warpgroups = ATTENTION_CONSUMERS if key_tiles <= 3 and head_dim <= 96 else 2
    work = items * heads
    slabs = key_tiles
    return {"work": work, "grid": min(work, sms), "key_tiles": key_tiles, "query_slabs": slabs,
            "warpgroups": warpgroups,
            "slabs_per_warpgroup": [len(range(c, slabs, warpgroups)) for c in range(warpgroups)],
            "kv_loads": 1, "buffers": buffers, "smem_bytes": 1024 + buffers * item}


def kernel_takes(seq: int, width: int, heads: int, head_dim: int, mlp: int) -> bool:
    """The kernel's stated limits (the counterpart of ``fused_block_fits``)."""
    return (head_dim in HEAD_DIMS and 1 <= seq <= MAX_SEQ and heads >= 1
            and width >= 8 and width % 8 == 0 and mlp >= 8 and mlp % 8 == 0)


def flatten_block_params(params) -> dict[str, torch.Tensor]:
    """bf16 operands from a ``ParallelTransformerBlock`` state_dict (flax names).

    The counterpart of ``_flatten_params``: every operand is rounded to
    bf16; the projections are stored transposed, [out, in], the B operand
    layout of the kernel's GEMMs, with Q, K and V stacked head-major into one
    [3 H Dh, C] matrix (rows ordered (projection, head, d)).
    """
    def p(name):
        return params[name].detach()

    width, heads, head_dim = p("self_att.dense_query.kernel").shape
    hd = heads * head_dim
    qkv = [p(f"self_att.dense_{n}.kernel").reshape(width, hd) for n in ("query", "key", "value")]
    ops = {
        "g1": p("norm_q.scale"),
        "wqkv_t": torch.cat(qkv, dim=1).t(),
        "sq": p("self_att.norm_query.scale"),
        "sk": p("self_att.norm_key.scale"),
        "wo_t": p("self_att.dense_out.kernel").reshape(hd, width).t(),
        "bo": p("self_att.dense_out.bias"),
        "g2": p("norm_attn.scale"),
        "w1_t": p("MLP_in.kernel").t(),
        "b1": p("MLP_in.bias"),
        "w2_t": p("MLP_out.kernel").t(),
        "b2": p("MLP_out.bias"),
    }
    return {k: v.to(torch.bfloat16).contiguous() for k, v in ops.items()}


# The layer's parameters by state_dict name, in the order the custom op
# ``tdspa::fused_transformer_block`` takes them.
PARAMS = (
    "norm_q.scale", "self_att.dense_query.kernel", "self_att.dense_key.kernel",
    "self_att.dense_value.kernel", "self_att.norm_query.scale", "self_att.norm_key.scale",
    "self_att.dense_out.kernel", "self_att.dense_out.bias", "norm_attn.scale",
    "MLP_in.kernel", "MLP_in.bias", "MLP_out.kernel", "MLP_out.bias",
)

# Flattened operands per parameter set: the first parameter (a view's base)
# keys the entry, so it dies with the tensor; inside it, every parameter's
# address, version counter and shape, so a new tensor or an in-place update
# (``load_state_dict``) flattens anew.
_OPERANDS = WeakIdKeyDictionary()


def cached_operands(params) -> dict[str, torch.Tensor]:
    """``flatten_block_params`` of the parameters (in ``PARAMS`` order),
    computed once per state of them. Inference tensors keep no version
    counter and are flattened on every call."""
    params = list(params)
    named = dict(zip(PARAMS, params))
    if any(p.is_inference() for p in params):
        return flatten_block_params(named)
    owner = params[0] if params[0]._base is None else params[0]._base
    key = tuple((p.data_ptr(), p._version, tuple(p.shape)) for p in params)
    cached = _OPERANDS.get(owner)
    if cached is None or cached[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            cached = (key, flatten_block_params(named))
        _OPERANDS[owner] = cached
    return cached[1]


def block_params(block) -> list[torch.Tensor]:
    """The layer's parameters in ``PARAMS`` order, from the module or a
    mapping by state_dict name."""
    named = dict(block.named_parameters()) if isinstance(block, torch.nn.Module) else block
    return [named[name] for name in PARAMS]


def _operands(block) -> dict[str, torch.Tensor]:
    """Flattened operands of a module or mapping (``cached_operands``)."""
    return cached_operands(block_params(block))


def _layernorm(v, g):
    """Bias-free LayerNorm with the two-pass variance, f32 (block.py:49-54)."""
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + NORM_EPS) * g


def _bf16(v):
    return v.to(torch.bfloat16).float()


def block_reference(x, ops, heads: int, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel's function: x [..., S, C] -> [..., S, C].

    Follows the TPU body's numerics: x rounded to bf16 at entry, bf16
    operands and bf16 rounding of ln1, q, k, v, the normalised
    probabilities, the attention output, ln2 and the GELU output; products
    of bf16 values summed in f32; statistics and residual sums in f32; the
    logits scaled in f32 after the product.
    """
    lead, (seq, width) = x.shape[:-2], x.shape[-2:]
    f = {k: v.float() for k, v in ops.items()}
    hd = f["wqkv_t"].shape[0] // 3
    head_dim = hd // heads
    xb = _bf16(x.reshape(-1, seq, width))
    ln1 = _bf16(_layernorm(xb, f["g1"]))
    q, k, v = (ln1 @ f["wqkv_t"].t()).split(hd, dim=-1)

    def rms(t, scale):
        t = t.unflatten(-1, (heads, head_dim))
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + NORM_EPS) * scale

    q, k = _bf16(rms(q, f["sq"])), _bf16(rms(k, f["sk"]))
    v = _bf16(v.unflatten(-1, (heads, head_dim)))
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * (1.0 / math.sqrt(head_dim))
    unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = _bf16(unnorm / unnorm.sum(-1, keepdim=True))
    att = _bf16(torch.einsum("nhqk,nkhd->nqhd", probs, v)).flatten(-2)
    y = xb + att @ f["wo_t"].t() + f["bo"]
    ln2 = _bf16(_layernorm(y, f["g2"]))
    hid = _bf16(F.gelu(ln2 @ f["w1_t"].t() + f["b1"], approximate="tanh"))
    out = y + (hid @ f["w2_t"].t() + f["b2"])
    return out.to(out_dtype).reshape(lead + (seq, width))


def fused_transformer_block(x, block, heads: int, out_dtype=torch.float32):
    """One unmasked self-attention ``ParallelTransformerBlock`` layer, fused.

    ``block`` is the module or a mapping of its parameters by state_dict
    name; the custom op ``tdspa::fused_transformer_block`` (``kernels/ops.py``)
    takes the parameters themselves and its CUDA implementation caches their
    flattened operands. x [..., S, C] f32 or bf16 -> [..., S, C] in
    ``out_dtype``. CUDA tensors launch the kernel (forward-only); CPU tensors
    run ``block_reference`` (directly where autograd records).
    """
    from tdspa_torch.kernels import ops

    params = block_params(block)
    named = dict(zip(PARAMS, params))
    seq, width = x.shape[-2:]
    cin, heads_p, head_dim = named["self_att.dense_query.kernel"].shape
    hd = heads_p * head_dim
    mlp = named["MLP_in.kernel"].shape[1]
    if cin != width or hd % heads:
        raise ValueError(f"x [..., {seq}, {width}] does not fit a block of {heads} heads and "
                         f"operands {(3 * hd, cin)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not on_cuda("fused_transformer_block", x, *params):
        if records(x, *params):
            return block_reference(x, flatten_block_params(named), heads, out_dtype)
        return ops.fused_transformer_block(x, params, heads, out_dtype)
    head_dim = hd // heads
    if not kernel_takes(seq, width, heads, head_dim, mlp):
        raise ValueError(f"kernel takes head widths {HEAD_DIMS}, S <= {MAX_SEQ} and C, MLP "
                         f"multiples of 8; got S={seq}, C={width}, H={heads}, Dh={head_dim}, "
                         f"MLP={mlp}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 x, got {x.dtype}")
    forward_only("fused_transformer_block", x, *params)
    lead = x.shape[:-2]
    out = ops.fused_transformer_block(x.reshape(-1, seq, width).contiguous(), params, heads,
                                      out_dtype)
    return out.reshape(lead + (seq, width))


def launch(xf, ops, heads: int, out_dtype):
    """All seven stages on contiguous CUDA x [N, S, C] and the flattened
    operands (the op's CUDA implementation); counts one block launch."""
    out, _ = launch_stages(xf.contiguous(), ops, heads, out_dtype)
    if out.numel():
        fused_transformer_block.launches += 1
    return out


def launch_stages(xf, ops, heads: int, out_dtype, stages: int = ALL_STAGES, bufs=None):
    """Launch the kernel's stages whose bit ``1 << i`` (``STAGES[i]``) is set
    in ``stages``, on contiguous CUDA x [N, S, C] and the flattened operands;
    ``bufs`` are the scratch tensors of an earlier call (new ones when None).
    Returns (out, bufs). ``fused_transformer_block`` runs all seven; one
    alone times that stage."""
    items, seq, width = xf.shape
    hd = ops["wqkv_t"].shape[0] // 3
    mlp = ops["w1_t"].shape[0]
    rows = items * seq
    out = torch.empty(xf.shape, dtype=out_dtype, device=xf.device)
    if rows == 0:
        return out, bufs

    def scratch(cols, dtype=torch.bfloat16):
        return torch.empty((rows, cols), dtype=dtype, device=xf.device)

    if bufs is None:
        xb = scratch(width) if xf.dtype == torch.float32 else xf
        bufs = [xb, scratch(width), scratch(3 * hd), scratch(hd), scratch(width, torch.float32),
                scratch(width), scratch(mlp)]
    sms = torch.cuda.get_device_properties(xf.device).multi_processor_count
    build.launch(
        "tdspa_block_forward", xf.device, xf.data_ptr(), out.data_ptr(),
        *(ops[name].data_ptr() for name in OPERANDS), *(b.data_ptr() for b in bufs),
        int(xf.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        items, seq, width, heads, hd // heads, mlp, stages, sms, 1.0 / math.sqrt(hd // heads),
    )
    return out, bufs


fused_transformer_block.launches = 0
