"""The row-norm wrapper (``kernels/norm.py``) on the CPU: its plain version is
the eager chain ``_Norm`` ran before it, bit for bit; the norms a block feeds
to its projections write the compute dtype only where that gives the same
bits; the autograd Function's plain backward is the gradient of the chain;
the shared norm (one output, one tensor a reader) gives the chain's values
and gradients, its cotangents summed in f32; the launch plan covers every
width of the two models. The kernel itself runs in
``tests/test_torch_cuda.py``.
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

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
    """The dtypes ``norm_q`` and ``norm_attn`` write in one call (a tuple of
    one a reader where the norm gives its readers tensors of their own), and
    the call's output."""
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[name] = out.dtype if isinstance(out, torch.Tensor) else tuple(
                o.dtype for o in out)
        return record

    hooks = [getattr(block, name).register_forward_hook(hook(name))
             for name in ("norm_q", "norm_attn")]
    out = block(*args)
    for h in hooks:
        h.remove()
    return seen, out


@pytest.mark.parametrize("cross", [False, True])
def test_block_norms_write_the_compute_dtype_with_the_same_bits(cross):
    """bf16 compute, f32 residual: the two norms before the projections write
    bf16, without autograd one tensor for all of the query norm's readers,
    under autograd one a reader (3, or 4 with the cross-attention); the
    block's output is the same bit for bit."""
    block = _block(cross=cross)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 5, 16), generator=gen)
    kv = torch.randn((2, 6, 12), generator=gen) if cross else None
    with torch.no_grad():
        seen, fast = _norm_dtypes(block, x, kv)
    assert seen == {"norm_q": torch.bfloat16, "norm_attn": torch.bfloat16}
    seen, recorded = _norm_dtypes(block, x, kv)
    assert seen == {"norm_q": (torch.bfloat16,) * (4 if cross else 3),
                    "norm_attn": torch.bfloat16}
    assert fast.dtype == recorded.dtype == torch.float32
    assert torch.equal(fast, recorded.detach())


@pytest.mark.parametrize("case", ["autograd", "quantize", "bf16_residual"])
def test_block_norms_keep_their_dtype(case):
    """Under ``quantize`` (the int8 layers quantise the f32 values) and with a
    bf16 residual over f32 compute, the norms write their own dtype (the
    residual's). Where autograd records, the projections read bf16, each
    its own tensor, and their gradients sum in f32: on the CPU every reader's
    tensor is its own cast of one f32 norm, where autograd adds them."""
    residual = torch.bfloat16 if case == "bf16_residual" else torch.float32
    block = _block(dtype=torch.float32 if case == "bf16_residual" else torch.bfloat16,
                   residual_dtype=residual, quantize=case == "quantize")
    x = torch.randn((2, 5, 16), generator=torch.Generator().manual_seed(3)).to(residual)
    if case != "autograd":
        with torch.no_grad():
            seen, _ = _norm_dtypes(block, x)
        assert seen == {"norm_q": residual, "norm_attn": residual}
        return
    read = {}

    def hook(name):
        def record(module, args):
            read[name] = args[0]
        return record

    projections = {"q": block.self_att.dense_query, "k": block.self_att.dense_key,
                   "v": block.self_att.dense_value, "mlp": block.MLP_in}
    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in projections.items()]
    seen, _ = _norm_dtypes(block, x)
    for h in hooks:
        h.remove()
    assert seen == {"norm_q": (torch.bfloat16,) * 3, "norm_attn": torch.bfloat16}
    assert all(t.dtype == torch.bfloat16 for t in read.values())
    q, k, v = read["q"], read["k"], read["v"]
    assert q is not k and k is not v and q is not v
    # Each reader's edge is a cast of the one f32 norm: the sum is in f32.
    sources = {id(t.grad_fn.next_functions[0][0]) for t in (q, k, v)}
    assert len(sources) == 1 and all(type(t.grad_fn).__name__ == "ToCopyBackward0"
                                     for t in (q, k, v))


def todays_block(block, x, kv=None):
    """``ParallelTransformerBlock.forward`` as it was before the shared norm:
    under autograd both norms wrote f32 and each projection cast its input to
    bf16; without autograd they wrote bf16 for all of them."""
    dtype = None if torch.is_grad_enabled() else block.dtype
    normed = block.norm_q(x, dtype)
    out = x + block.self_att(normed, normed)
    if kv is not None:
        out = out + block.cross_att(normed, kv)
    h = F.gelu(block.MLP_in(block.norm_attn(out, dtype)), approximate="tanh")
    return out + block.MLP_out(h).to(block.residual_dtype)


@pytest.mark.parametrize("cross", [False, True])
def test_block_gradients_equal_todays_chain(cross):
    """Under autograd every parameter's gradient and the input's equal those
    of an explicit copy of the chain the shared norm replaced, within f32
    summation rounding; without autograd the output is that chain's bit for
    bit."""
    block = _block(cross=cross)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 5, 16), generator=gen)
    kv = torch.randn((2, 6, 12), generator=gen) if cross else None
    with torch.no_grad():
        assert torch.equal(block(x, kv), todays_block(block, x, kv))
    grads = []
    for forward in (block, lambda a, b: todays_block(block, a, b)):
        xs = x.clone().requires_grad_()
        loss = forward(xs, kv).square().mean()
        grads.append(torch.autograd.grad(loss, [xs, *block.parameters()]))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def _shared_inputs(readers, centered, x_dtype=torch.float32):
    x, scale = _inputs((3, 7, 64), x_dtype, seed=6 + readers + 10 * centered)
    gen = torch.Generator().manual_seed(readers)
    dys = [torch.randn((3, 7, 64), generator=gen).to(torch.bfloat16) for _ in range(readers)]
    return x, scale, dys


@pytest.mark.parametrize("readers", [1, 2, 3, 4])
@pytest.mark.parametrize("centered", [True, False])
def test_shared_norm_is_the_f32_norm_rounded_once(readers, centered):
    """The shared entry (the plain version) and its autograd Function (the
    launch's counterpart on the card) give ``readers`` bf16 tensors, each the
    f32 norm rounded once, each with its own autograd edge."""
    x, scale, _ = _shared_inputs(readers, centered)
    want = eager_chain(x, scale, centered, torch.float32).to(torch.bfloat16)
    xs = x.clone().requires_grad_()
    for fn in (norm.row_norm_shared, norm.row_norm_shared_fn):
        outs = fn(xs, scale, centered, torch.bfloat16, readers)
        assert len(outs) == readers
        assert all(o.dtype == torch.bfloat16 and torch.equal(o, want) for o in outs)
        edges = {(o.grad_fn, o.output_nr) for o in outs}
        assert len({id(o) for o in outs}) == readers and len(edges) == readers
    with torch.no_grad():
        outs = norm.row_norm_shared_fn(x, scale, centered, torch.bfloat16, readers)
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("readers", [1, 2, 3, 4])
@pytest.mark.parametrize("centered", [True, False])
def test_shared_norm_gradients_equal_todays_chain(readers, centered):
    """x and scale gradients through the shared Function (its backward sums
    the readers' bf16 cotangents in f32) equal those of the chain it
    replaces (an f32 norm, one cast a reader, autograd adding in f32),
    within f32 summation rounding."""
    x, scale, dys = _shared_inputs(readers, centered)
    grads = []
    for fn in (norm.row_norm_shared_fn, None):
        xs, ss = x.clone().requires_grad_(), scale.clone().requires_grad_()
        if fn is None:
            full = eager_chain(xs, ss, centered, torch.float32)
            outs = [full.to(torch.bfloat16) for _ in range(readers)]
        else:
            outs = fn(xs, ss, centered, torch.bfloat16, readers)
        grads.append(torch.autograd.grad(outs, (xs, ss), dys))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("readers", [1, 2, 3, 4])
@pytest.mark.parametrize("centered", [True, False])
def test_plain_backward_takes_the_f32_sum_of_the_cotangents(readers, centered):
    """``row_norm_backward`` of several cotangents is the backward of their
    f32 sum, added in the order given."""
    x, scale, dys = _shared_inputs(readers, centered, torch.bfloat16)
    total = dys[0].float()
    for d in dys[1:]:
        total = total + d.float()
    got = norm.row_norm_backward(x, scale, dys, centered)
    want = norm.row_norm_backward_reference(x, scale, dys[0] if readers == 1 else total,
                                            centered)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(norm.cotangent_sum(dys), dys[0] if readers == 1 else total)


@pytest.mark.parametrize("readers", [2, 4])
@pytest.mark.parametrize("centered", [True, False])
def test_shared_function_passes_gradcheck_in_f64(readers, centered):
    x, scale, _ = _clamped_row_inputs(centered)
    args = (x.clone().requires_grad_(), scale.clone().requires_grad_())
    assert torch.autograd.gradcheck(
        lambda a, s: norm.row_norm_shared_fn(a, s, centered, torch.float64, readers), args)


def test_shared_norm_and_summing_backward_refuse_what_the_kernel_does_not_take():
    x, scale = _inputs((3, 64), torch.float32)
    for readers in (0, 5):
        with pytest.raises(ValueError, match="1 to 4 readers"):
            norm.row_norm_shared(x, scale, True, torch.bfloat16, readers)
    dy = torch.ones_like(x)
    for dys in ((), (dy,) * 5):
        with pytest.raises(ValueError, match="sums 1 to 4 cotangents"):
            norm.row_norm_backward(x, scale, dys, True)
    with pytest.raises(ValueError, match="dy must be"):
        norm.row_norm_backward(x, scale, (dy, dy[:2]), True)
    with pytest.raises(TypeError, match="cotangents of one dtype"):
        norm.row_norm_backward(x, scale, (dy, dy.to(torch.bfloat16)), True)


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


@pytest.mark.parametrize("width", STACK_WIDTHS + HEAD_WIDTHS + (12, 100, 1532))
def test_backward_plan_moves_bf16_cotangents_in_16_byte_words(width):
    """f32 x with bf16 cotangents: 8-value vectors where the width is a
    multiple of 8 (the source's rule too), else x's own plan; every other
    pairing of dtypes takes x's plan."""
    want = norm.plan(width, 2) if width % 8 == 0 else norm.plan(width, 4)
    assert norm.backward_plan(width, 4, 2) == want
    assert norm.backward_plan(width, 4, 4) == norm.plan(width, 4)
    if width % 8 == 0:
        assert norm.backward_plan(width, 2, 2) == norm.backward_plan(width, 2, 4) == want
    assert "const bool wide = !x_bf16 && dy_bf16 && width % 8 == 0;" in CSRC.read_text()


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
    assert f"constexpr int MAX_COTANGENTS = {norm.MAX_COTANGENTS};" in src
    assert "constexpr int THREADS = 256;" in src and norm.WARPS == 256 // 32
    assert "return nv * vec <= 16 ? 2 : 1;" in src
    assert "norm" in norm.build.KERNELS
