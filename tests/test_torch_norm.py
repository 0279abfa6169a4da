"""The row-norm wrapper (``kernels/norm.py``) on the CPU: its plain version is
the eager chain ``_Norm`` ran before it, bit for bit; the norms a block feeds
to its projections write the compute dtype only where that gives the same
bits; the autograd Function's plain backward is the gradient of the chain;
the launch plan covers every width of the two models. The kernel itself runs
in ``tests/test_torch_cuda.py``.
"""

from pathlib import Path

import pytest
import torch

from tdspa_torch.core import attention as tattn
from tdspa_torch.kernels import norm

CSRC = Path(__file__).resolve().parents[1] / "tdspa_torch" / "csrc" / "norm.cu"
# The stacks' widths of both models (3DSPA 384/512/1152/1280, TRAJAN
# 256/512/896/1024) and the heads' (96, 64).
STACK_WIDTHS = (256, 384, 512, 896, 1024, 1152, 1280)
HEAD_WIDTHS = (64, 96)


def eager_chain(x, scale, centered, dtype):
    """``_Norm.forward`` as it was written before the kernel."""
    x32 = x.float()
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    if centered:
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = x32 - mean
    else:
        var, y = mean2, x32
    mul = torch.rsqrt(var + 1e-6) * scale
    return (y * mul).to(dtype)


def _inputs(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    scale = torch.rand(shape[-1], generator=gen) + 0.5
    return x, scale


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_eager_chain_bit_for_bit(centered, x_dtype, out_dtype):
    x, scale = _inputs((3, 7, 48), x_dtype)
    want = eager_chain(x, scale, centered, out_dtype)
    module = tattn._Norm(48, centered, out_dtype, "cpu")
    module.scale.data.copy_(scale)
    with torch.no_grad():
        got = [norm.row_norm_reference(x, scale, centered, out_dtype),
               norm.row_norm(x, scale, centered, out_dtype),  # through tdspa::row_norm
               torch.ops.tdspa.row_norm(x, scale, centered, out_dtype), module(x)]
    for g in got:
        assert g.dtype == out_dtype and torch.equal(g, want)
    with torch.enable_grad():  # autograd records through the chain itself
        recorded = module(x.clone().requires_grad_())
    assert recorded.grad_fn is not None and torch.equal(recorded, want)


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bf16_output_is_the_f32_output_rounded(centered, x_dtype):
    x, scale = _inputs((5, 64), x_dtype, seed=1)
    module = tattn._Norm(64, centered, torch.float32, "cpu")
    module.scale.data.copy_(scale)
    with torch.no_grad():
        narrow = module(x, torch.bfloat16)
        assert torch.equal(narrow, module(x).to(torch.bfloat16))
        want = eager_chain(x, scale, centered, torch.float32).to(torch.bfloat16)
        assert torch.equal(narrow, want)


def _block(dtype=torch.bfloat16, residual_dtype=torch.float32, quantize=False, cross=False):
    block = tattn.ParallelTransformerBlock(16, 24, 2, 16, kv_width=12 if cross else None,
                                           dtype=dtype, residual_dtype=residual_dtype,
                                           quantize=quantize)
    tattn.reset_parameters(block, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return block


def _norm_dtypes(block, *args):
    """The dtypes ``norm_q`` and ``norm_attn`` write in one call, and its output."""
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[name] = out.dtype
        return record

    hooks = [getattr(block, name).register_forward_hook(hook(name))
             for name in ("norm_q", "norm_attn")]
    out = block(*args)
    for h in hooks:
        h.remove()
    return seen, out


@pytest.mark.parametrize("cross", [False, True])
def test_block_norms_write_the_compute_dtype_with_the_same_bits(cross):
    """bf16 compute, f32 residual, no autograd: the two norms before the
    projections write bf16, and the block's output equals the output with the
    norms in f32 (autograd recording keeps them f32) bit for bit."""
    block = _block(cross=cross)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 5, 16), generator=gen)
    kv = torch.randn((2, 6, 12), generator=gen) if cross else None
    with torch.no_grad():
        seen, fast = _norm_dtypes(block, x, kv)
    assert seen == {"norm_q": torch.bfloat16, "norm_attn": torch.bfloat16}
    seen, kept = _norm_dtypes(block, x, kv)
    assert seen == {"norm_q": torch.float32, "norm_attn": torch.float32}
    assert fast.dtype == kept.dtype == torch.float32 and torch.equal(fast, kept.detach())


@pytest.mark.parametrize("case", ["autograd", "quantize", "bf16_residual"])
def test_block_norms_keep_their_dtype(case):
    """Where autograd records, under ``quantize`` (the int8 layers quantise
    the f32 values) and with a bf16 residual over f32 compute, the norms
    write their own dtype (the residual's)."""
    residual = torch.bfloat16 if case == "bf16_residual" else torch.float32
    block = _block(dtype=torch.float32 if case == "bf16_residual" else torch.bfloat16,
                   residual_dtype=residual, quantize=case == "quantize")
    x = torch.randn((2, 5, 16), generator=torch.Generator().manual_seed(3)).to(residual)
    with torch.set_grad_enabled(case == "autograd"):
        seen, _ = _norm_dtypes(block, x)
    assert seen == {"norm_q": residual, "norm_attn": residual}


def _clamped_row_inputs(centered):
    """f64 rows, the last constant 0.7 over 6 values: E[x^2] - E[x]^2 is
    -1.7e-16 there, so the clamp holds its variance at 0."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 6), generator=gen, dtype=torch.float64) * 1.5 + 0.3
    x[-1] = 0.7
    scale = torch.rand(6, generator=gen, dtype=torch.float64) + 0.5
    dy = torch.randn((4, 6), generator=gen, dtype=torch.float64)
    return x, scale, dy


@pytest.mark.parametrize("centered", [True, False])
def test_autograd_function_passes_gradcheck_in_f64(centered):
    x, scale, _ = _clamped_row_inputs(centered)
    if centered:
        last = x[-1]
        assert ((last * last).mean() - last.mean() ** 2).item() < 0  # the clamp holds
    args = (x.clone().requires_grad_(), scale.clone().requires_grad_())
    assert torch.autograd.gradcheck(
        lambda a, s: norm.row_norm_fn(a, s, centered, torch.float64), args)


@pytest.mark.parametrize("centered", [True, False])
def test_plain_backward_is_the_gradient_of_the_chain(centered):
    """In f64, ``row_norm_backward_reference`` equals autograd through the
    eager chain, the clamped row too (whose variance term is dropped)."""
    x, scale, dy = _clamped_row_inputs(centered)
    xs, ss = x.clone().requires_grad_(), scale.clone().requires_grad_()
    out = norm.row_norm_reference(xs, ss, centered, torch.float64)
    want = torch.autograd.grad(out, (xs, ss), dy)
    got = norm.row_norm_backward(x, scale, dy, centered)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    if centered:  # the clamped row: r (g - mean(g)) alone
        r = (1e-6) ** -0.5
        g = dy[-1] * scale
        torch.testing.assert_close(got[0][-1], r * (g - g.mean()), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width,itemsize", [(w, 4) for w in STACK_WIDTHS]
                         + [(w, 2) for w in STACK_WIDTHS + HEAD_WIDTHS]
                         + [(8, 2), (16, 4), (160, 4), (8, 4), (48, 4), (384, 4)])
def test_plan_covers_the_row(width, itemsize):
    """Every vector of the row lies in some lane; the widths the models run
    (f32 stacks, bf16 heads) fill their lanes exactly (no masked vector);
    vectors are 16 bytes."""
    p = norm.plan(width, itemsize)
    assert p["lanes"] in (1, 2, 4, 8, 16, 32) and p["steps"] >= 1
    assert p["vec"] == 16 // itemsize and p["steps"] * p["vec"] * 32 <= norm.MAX_VALUES
    assert p["lanes"] * p["steps"] * p["vec"] >= width
    if (width, itemsize) in [(w, 4) for w in STACK_WIDTHS] + [(w, 2) for w in HEAD_WIDTHS]:
        assert p["lanes"] * p["steps"] * p["vec"] == width
    per_group = 2 if p["steps"] * p["vec"] <= 16 else 1  # a lane's share of a row
    assert p["rows_per_block"] == norm.WARPS * (32 // p["lanes"]) * per_group


@pytest.mark.parametrize("width,itemsize", [(1537, 4), (1540, 4), (1544, 2), (1792, 4),
                                             (2048, 2)])
def test_plan_refuses_rows_wider_than_a_warp_holds(width, itemsize):
    with pytest.raises(ValueError, match="row-norm kernel takes rows"):
        norm.plan(width, itemsize)


@pytest.mark.parametrize("width,itemsize", [(12, 2), (7, 4), (385, 4), (100, 2)])
def test_plan_refuses_widths_off_the_16_byte_vector(width, itemsize):
    with pytest.raises(ValueError, match=f"a multiple of {16 // itemsize}"):
        norm.plan(width, itemsize)


@pytest.mark.parametrize("rows", [1, 100, 10 ** 7])
def test_backward_grid_is_whole_waves_or_one_block_a_tile(rows):
    p = norm.plan(384, 4)
    parts = norm.backward_parts(rows, p, 132)
    tiles = -(-rows // p["rows_per_block"])
    assert parts == min(tiles, 12 * 132)
    assert all(parts == tiles or parts % (132 * k) == 0 for k in (1, 2, 3, 4, 6))


def test_constants_match_the_source():
    src = CSRC.read_text()
    assert f"constexpr int MAX_VALUES = {norm.MAX_VALUES};" in src
    assert "constexpr int THREADS = 256;" in src and norm.WARPS == 256 // 32
    assert "return nv * vec <= 16 ? 2 : 1;" in src
    assert "norm" in norm.build.KERNELS
