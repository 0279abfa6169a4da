"""The ViT block's kernel wrappers (``kernels/vit_block.py``) on the CPU: their
plain versions are the eager chain the block ran before them, bit for bit; a
tiny SwiGLU ViT and a tiny MLP ViT give what the block and encoder code
before them gave (kept below as ``eager_block`` and ``eager_dinov2``), in
every pairing of compute and stream dtypes; the wrappers refuse what the
kernels do not take on either device; the launch plan and the constants
match ``csrc/vit_block.cu``. The kernels themselves run in
``tests/test_torch_cuda.py``. Imports no JAX.
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from tdspa_torch.core.attention import Dense, masked_dot_product_attention
from tdspa_torch.core.layers import LayerNorm, init_parameters
from tdspa_torch.features import vit
from tdspa_torch.kernels import vit_block

CSRC = Path(__file__).resolve().parents[1] / "tdspa_torch" / "csrc" / "vit_block.cu"
# ViT-S/B/L/g's widths.
WIDTHS = (384, 768, 1024, 1536)
F32, BF16 = torch.float32, torch.bfloat16


def xla_heads(att, q, k, v):
    """The parent's attention heads on the CPU (the XLA path)."""
    return masked_dot_product_attention(q, k, v, compute_dtype=att.dtype)


def eager_block(block, x, heads=xla_heads):
    """``_Block.forward`` as it was written before the kernels, with the
    attention's heads from ``heads(attention, q, k, v)``."""
    rd = block.residual_dtype
    att = block.attention

    def attention(x):
        return att.output(heads(att, att.query(x), att.key(x), att.value(x)))

    def ffn(x):
        if block.swiglu:
            x1, x2 = block.weights_in(x).chunk(2, dim=-1)
            return block.weights_out(F.silu(x1) * x2)
        return block.fc2(F.gelu(block.fc1(x), approximate=block.gelu))

    h = attention(block.norm1(x)) * block.layer_scale1.to(rd)
    x = x.to(rd) + h
    h = ffn(block.norm2(x)) * block.layer_scale2.to(rd)
    return x + h.to(rd)


def eager_dinov2(model, pixel_values, taps=()):
    """``Dinov2.forward`` as it was written before the kernels."""
    x = model.patch_embed(pixel_values)
    batch, hp, wp, dim = x.shape
    cls = model.cls_token.expand(batch, 1, dim)
    x = torch.cat([cls, x.reshape(batch, hp * wp, dim).to(cls.dtype)], dim=1)
    x = x + vit.interpolate_pos_embed(model.pos_embed, hp, wp, model.config.pos_resize)
    tapped = {}
    for i in range(model.config.num_layers):
        x = eager_block(getattr(model, f"layer_{i}"), x)
        if i in taps:
            tapped[i] = x
    out = model.layernorm(x)
    return (out, [tapped[i] for i in taps]) if taps else out


def _vectors(width, gen, n):
    return [torch.randn(width, generator=gen) * 0.5 + (1.0 if i % 2 else 0.0) for i in range(n)]


@pytest.mark.parametrize("out_dtype", [F32, BF16], ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("residual", [False, True], ids=["norm", "residual_norm"])
@pytest.mark.parametrize("x_dtype,h_dtype", [(F32, BF16), (F32, F32), (BF16, BF16)],
                         ids=["f32_stream", "f32_stream_f32_h", "bf16_stream"])
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_row_version_is_the_eager_chain(width, x_dtype, h_dtype, residual, out_dtype):
    """The output projection's bias add (``DenseGeneral``), the layer scale
    cast to the stream's dtype, the residual sum and ``core/layers.py``'s
    LayerNorm in ``out_dtype``, against one call: equal bit for bit."""
    gen = torch.Generator().manual_seed(width)
    x = (torch.randn((2, 5, width), generator=gen) * 3 + 0.5).to(x_dtype)
    h = torch.randn((2, 5, width), generator=gen).to(h_dtype)
    bias, layer_scale, scale, norm_bias = _vectors(width, gen, 4)
    ln = LayerNorm(width, 1e-6, out_dtype)
    with torch.no_grad():
        ln.scale.copy_(scale)
        ln.bias.copy_(norm_bias)
    norm = (ln.scale, ln.bias, ln.eps)
    with torch.no_grad():
        if residual:
            want_x = x + (h + bias.to(h_dtype)) * layer_scale.to(x_dtype)
            got_x, got = vit_block.vit_residual_norm(x, (h, bias, layer_scale), norm, out_dtype)
            assert got_x.dtype == x_dtype and torch.equal(got_x, want_x)
            assert torch.equal(vit_block.vit_residual_norm(x, (h, bias, layer_scale)), want_x)
        else:
            want_x = x
            got = vit_block.vit_residual_norm(x, norm=norm, out_dtype=out_dtype)
        want = ln(want_x)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_gate_is_the_eager_chain(dtype):
    """``swiglu_gate`` on the first GEMM without its bias equals the biased
    ``Dense`` split, SiLU and product (ViT-g's widths: 1536 -> 2 x 4096)."""
    gen = torch.Generator().manual_seed(3)
    dense = Dense(1536, 2 * 4096, dtype, "cpu")
    init_parameters(dense, 0, "cpu")
    with torch.no_grad():
        dense.bias.normal_(0.0, 0.5, generator=gen)
        x = torch.randn((3, 7, 1536), generator=gen)
        x1, x2 = dense(x).chunk(2, dim=-1)
        want = F.silu(x1) * x2
        got = vit_block.swiglu_gate(vit._unbiased(dense, x), dense.bias)
    assert got.dtype == dtype and torch.equal(got, want)


def _tiny_vit(ffn, dtype, residual_dtype, seed):
    config = vit.ViTConfig(hidden_size=48, num_layers=2, num_heads=3, patch_size=14,
                           image_size=28, ffn=ffn)
    model = vit.Dinov2(config, dtype, residual_dtype, device="cpu")
    init_parameters(model, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # every bias, scale and layer scale away from its init
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


@pytest.mark.parametrize("dtype,residual_dtype", [(F32, F32), (BF16, F32), (BF16, BF16),
                                                  (F32, BF16)],
                         ids=["f32", "bf16_compute", "bf16", "f32_compute_bf16_stream"])
@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_tiny_vit_equals_the_eager_block_and_encoder(ffn, dtype, residual_dtype):
    """Every block and the whole encoder (with taps, as the depth estimator
    reads them) equal the code before the kernels, bit for bit."""
    model = _tiny_vit(ffn, dtype, residual_dtype, seed=7)
    img = torch.randn((2, 28, 42, 3), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got, got_taps = model(img, taps=(0, 1))
        want, want_taps = eager_dinov2(model, img, taps=(0, 1))
        x = torch.randn((2, 7, 48), generator=torch.Generator().manual_seed(9))
        block_got, block_want = model.layer_0(x), eager_block(model.layer_0, x)
    assert got.dtype == F32 and torch.equal(got, want)
    for a, b in zip(got_taps, want_taps):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert block_got.dtype == block_want.dtype and torch.equal(block_got, block_want)


def test_cpu_runs_launch_no_kernel():
    before = vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches
    model = _tiny_vit("swiglu", BF16, F32, seed=1)
    with torch.no_grad():
        model(torch.randn((1, 28, 28, 3)))
    assert (vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches) == before


def _row_case(case):
    """(x, residual, norm, out_dtype) of one refused call."""
    width = {"width_12": 12, "width_1544": 1544, "width_2048": 2048}.get(case, 48)
    x = torch.randn((3, width))
    h, bias, layer_scale, scale, norm_bias = (torch.randn((3, width)), *torch.randn(4, width))
    out_dtype = F32
    if case == "x_f64":
        x = x.double()
    elif case == "h_wider_than_x":
        x = x.to(BF16)
    elif case == "h_shape":
        h = h[:2]
    elif case == "bias_shape":
        bias = bias[:40]
    elif case == "bias_bf16":
        bias = bias.to(BF16)
    elif case == "scale_shape":
        scale = torch.randn(width + 8)
    elif case == "out_f16":
        out_dtype = torch.float16
    residual = None if case == "nothing" else (h, bias, layer_scale)
    norm = None if case == "nothing" else (scale, norm_bias, 1e-6)
    return x, residual, norm, out_dtype


ROW_CASES = ["width_12", "width_1544", "width_2048", "x_f64", "h_wider_than_x", "h_shape",
             "bias_shape", "bias_bf16", "scale_shape", "out_f16", "nothing"]


@pytest.mark.parametrize("case", ROW_CASES)
def test_row_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Rows no multiple of 8 or over 1536 values, f64, an f32 projection into
    a bf16 stream (its sum would leave the stream's dtype), shapes and dtypes
    of the vectors, an f16 output, and a call with nothing to do: ValueError
    before any arithmetic, on the CPU as on the card."""
    x, residual, norm, out_dtype = _row_case(case)
    with pytest.raises(ValueError):
        vit_block.vit_residual_norm(x, residual, norm, out_dtype)


@pytest.mark.parametrize("case", ["odd_last_axis", "hidden_off_the_word", "bias_length",
                                  "y_f16", "bias_f16"])
def test_gate_wrapper_refuses_what_the_kernel_does_not_take(case):
    y, bias = torch.randn((4, 2 * 16)).to(BF16), torch.randn(2 * 16)
    if case == "odd_last_axis":
        y = torch.randn((4, 33)).to(BF16)
    elif case == "hidden_off_the_word":  # F = 12: no multiple of 8 bf16 values
        y, bias = torch.randn((4, 24)).to(BF16), torch.randn(24)
    elif case == "bias_length":
        bias = torch.randn(30)
    elif case == "y_f16":
        y = y.to(torch.float16)
    else:
        bias = bias.to(torch.float16)
    with pytest.raises(ValueError):
        vit_block.swiglu_gate(y, bias)


@pytest.mark.parametrize("width,lanes,steps", [(384, 16, 3), (768, 32, 3), (1024, 32, 4),
                                               (1280, 32, 5), (1536, 32, 6), (48, 2, 3),
                                               (8, 1, 1)])
def test_plan_holds_each_vit_width_in_one_warp(width, lanes, steps):
    p = vit_block.plan(width)
    assert p == {"lanes": lanes, "steps": steps}
    assert lanes * steps * vit_block.VEC >= width


def test_constants_match_the_source():
    src = CSRC.read_text()
    assert f"constexpr int MAX_VALUES = {vit_block.MAX_VALUES};" in src
    assert f"constexpr int VEC = {vit_block.VEC};" in src
    assert "return nv * VEC <= 16 ? 2 : 1;" in src
    assert "vit_block" in vit_block.build.KERNELS
    assert "--fmad=false" in vit_block.build.flags("vit_block")
