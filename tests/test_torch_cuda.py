"""The port's CUDA kernels on a GPU (marked ``cuda``; skip without a GPU).

Imports no JAX, so it also runs on a GPU host that has none (the repository's
``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version as in ``tests/test_torch_attention.py``
(2e-2 abs, + 2**-7 rel for a bf16 output), for both attention kernels and
the fused block; the attention's backward kernel within 2e-2 of each
gradient's largest value (it rounds g and dS to bf16 as tensor-core
operands, then each output to bf16); the int8 and bilinear kernels equal their plain versions
bit for bit; the ViT block's row kernel equals its plain version's stream bit
for bit, and its norm within f32 rounding of the row plus a bf16 ulp; the
SwiGLU gate within an ulp; the tiny bf16 model or ViT with the kernel vs the same one with
the plain attention path, 5e-2 of the output range (the two round
differently inside every attention).
"""

import pytest
import torch

from tdspa_torch.kernels.attention import (
    attention_backward,
    attention_backward_reference,
    attention_reference,
    fused_attention_fn,
    fused_masked_attention,
)
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_3d, to_torch

ATOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, batch, seq, kv_len, heads, depth, masked, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (
        torch.randn((batch, n, heads, depth), generator=gen, device=device).to(torch.bfloat16)
        for n in (seq, kv_len, kv_len)
    )
    mask = None
    if masked:
        mask = torch.rand((batch, kv_len), generator=gen, device=device) > 0.3
        mask[0] = False  # item 0 attends to nothing: the mean of its values
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 151, 151, 8, 96, True), (1, 128, 2048, 8, 96, False),
                                   (2, 77, 1000, 8, 64, True), (3, 5, 9, 2, 8, True)])
def test_kernel_matches_plain_version(cuda_device, shape):
    q, k, v, mask = _inputs(cuda_device, *shape)
    for out_dtype, rtol in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)):
        before = fused_masked_attention.launches
        got = fused_masked_attention(q, k, v, mask, out_dtype=out_dtype)
        assert fused_masked_attention.launches == before + 1
        want = attention_reference(q, k, v, mask, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=rtol)
    if mask is not None:
        mean_v = v[0].float().mean(dim=0)
        torch.testing.assert_close(fused_masked_attention(q, k, v, mask)[0],
                                   mean_v.expand_as(q[0]), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 151, 151, 8, 96, True), (4, 129, 129, 8, 8, False), (3, 1, 300, 2, 128, True),
    (2, 151, 151, 4, 64, "rows"), (1, 128, 2048, 8, 96, "rows"), (1, 129, 1000, 8, 64, True),
    (1, 128, 2048, 2, 128, False), (2, 5, 1000, 3, 8, "rows"),
])
def test_kernel_matches_plain_version_across_the_work_plan(cuda_device, shape):
    """Head widths 8, 64, 96 and 128 (one and two 64-column boxes), S = 151,
    129 and 1 (row tiles with a dead warpgroup), K = 2048 and 1000 split into
    key chunks and merged by a second kernel (the ragged last chunk too), and
    rows whose keys are all masked, whole or split: the mean of V."""
    from tdspa_torch.kernels.attention import work_plan

    batch, seq, kv_len, heads, depth, masked = shape
    q, k, v, mask = _inputs(cuda_device, batch, seq, kv_len, heads, depth, bool(masked))
    if masked == "rows":
        mask[1:, : kv_len // 2] = False  # other items lose a whole chunk or more
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if batch == 1 and kv_len >= 1000:
        assert work_plan(batch, seq, kv_len, heads, sms)["chunks"] > 1  # the split path
    for out_dtype, rtol in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)):
        before = fused_masked_attention.launches
        got = fused_masked_attention(q, k, v, mask, out_dtype=out_dtype)
        assert fused_masked_attention.launches == before + 1 and got.dtype == out_dtype
        want = attention_reference(q, k, v, mask, out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=rtol)
        if mask is not None:
            mean_v = v[0].float().mean(dim=0)
            torch.testing.assert_close(got[0].float(), mean_v.expand_as(q[0]).float(),
                                       atol=ATOL, rtol=rtol)


@pytest.mark.cuda
def test_kernel_refuses_inputs_that_require_grad(cuda_device):
    q, k, v, _ = _inputs(cuda_device, 1, 4, 4, 1, 8, False)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_masked_attention(q.requires_grad_(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["bilinear", "cost_patches"])
def test_forward_only_wrappers_refuse_autograd(cuda_device, wrapper):
    """A kernel's output carries no gradient: the bilinear and cost-patch
    wrappers raise where autograd would record through them on CUDA tensors,
    and launch under no_grad or inference mode."""
    from tdspa_torch.kernels.bilinear import bilinear_sample
    from tdspa_torch.kernels.matcher import cost_patches_multi

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    feats = torch.randn((3, 10, 12, 16), generator=gen, device=cuda_device)
    if wrapper == "bilinear":
        args = [feats, torch.rand((5, 3, 2), generator=gen, device=cuda_device) * 9]
        fn = bilinear_sample
    else:
        args = [feats, torch.randn((5, 2, 16), generator=gen, device=cuda_device),
                torch.rand((5, 3, 2), generator=gen, device=cuda_device) * 9]
        fn = cost_patches_multi
    for i in range(len(args)):
        recorded = [x.clone().requires_grad_(j == i) for j, x in enumerate(args)]
        with pytest.raises(NotImplementedError, match="forward-only"):
            fn(*recorded)
        before = fn.launches
        with torch.no_grad():
            fn(*recorded)
        with torch.inference_mode():
            fn(*args)
        assert fn.launches == before + 2


@pytest.mark.cuda
def test_custom_ops_launch_the_kernels(cuda_device):
    """The four ``tdspa::`` ops on CUDA tensors launch their kernels (each
    counter moves by one) and give the plain versions' results: bit for bit
    for bilinear and int8, 2e-2 for attention and the block."""
    from tdspa_torch.core.attention import ParallelTransformerBlock, reset_parameters
    from tdspa_torch.kernels import block as kb
    from tdspa_torch.kernels import ops
    from tdspa_torch.kernels import quant_matmul as qmm
    from tdspa_torch.kernels.bilinear import bilinear_sample, bilinear_sample_reference

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, mask = _inputs(cuda_device, 2, 9, 9, 2, 64, True)
    grid = torch.randn((4, 9, 7, 24), generator=gen, device=cuda_device)
    coords = torch.rand((30, 4, 2), generator=gen, device=cuda_device) * 10 - 1
    x = torch.randn((70, 48), generator=gen, device=cuda_device)
    w = torch.randn((48, 40), generator=gen, device=cuda_device) * 0.05
    block = ParallelTransformerBlock(64, 96, 2, 64, fused_block=True, device=cuda_device)
    reset_parameters(block, gen)
    xb = torch.randn((3, 9, 64), generator=gen, device=cuda_device)
    cases = [
        (fused_masked_attention, lambda: torch.ops.tdspa.fused_masked_attention(
            q, k, v, mask, torch.float32), attention_reference(q, k, v, mask), 2e-2),
        (bilinear_sample, lambda: torch.ops.tdspa.bilinear_sample(grid, coords, torch.float32),
         bilinear_sample_reference(grid, coords), 0.0),
        (qmm.quant_matmul, lambda: ops.quant_matmul(x, w), qmm.quant_matmul_reference(x, w), 0.0),
        (kb.fused_transformer_block, lambda: ops.fused_transformer_block(
            xb, kb.block_params(block), 2, torch.float32),
         kb.block_reference(xb, kb._operands(block), 2), 2e-2),
    ]
    with torch.inference_mode():
        for wrapper, call, want, atol in cases:
            before = wrapper.launches
            got = call()
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1, wrapper.__name__
            torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["default", "quantize", "fused_block"])
def test_exported_tail_runs_the_kernels(cuda_device, knob, tmp_path):
    """A tiny CUDA tail exported on fake tensors, saved and loaded, called on
    the card: the kernels' launches per call (5 attention and 3 bilinear;
    quantised 28 int8; fused block 2 block and 3 attention), and the eager
    tail's outputs exactly (the same kernels on the same inputs)."""
    from tdspa_torch.infer import export
    from tdspa_torch.infer.pipeline import fused_tail
    from tdspa_torch.kernels import quant_matmul as qmm
    from tdspa_torch.kernels.bilinear import bilinear_sample
    from tdspa_torch.kernels.block import fused_transformer_block

    t, h, w, n, s, nq = 12, 32, 32, 16, 8, 4
    model = tiny_model_3d(t, device=cuda_device, dtype=torch.bfloat16, fused_attention=True,
                          qkv_size=64, **({} if knob == "default" else {knob: True}))
    shapes = dict(num_tracks=n, num_frames=t, video_hw=(h, w), num_support=s, num_queries=nq,
                  use_dino=True, use_depth=True)
    path = str(tmp_path / "tail.pt2")
    export.save_exported(export.export_serving_tail(model, dino_grid_hw=(3, 3), **shapes), path)
    loaded = export.load_exported(path)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    inputs = (torch.rand((n, t, 2), generator=gen, device=cuda_device) * (w - 1),
              (torch.rand((n, t, 1), generator=gen, device=cuda_device) > 0.2).float(),
              torch.randn((t, 3, 3, 768), generator=gen, device=cuda_device),
              torch.rand((t, h, w, 1), generator=gen, device=cuda_device) + 0.5)
    perm = torch.randperm(n, device=cuda_device)
    ts = torch.randint(0, t, (nq,), device=cuda_device)
    params = export.serving_params(model)
    counters = (fused_masked_attention, bilinear_sample, qmm.quant_matmul, fused_transformer_block)
    with torch.inference_mode():
        before = [c.launches for c in counters]
        got = loaded.call(params, perm, ts, *inputs)
        launched = [c.launches - b for c, b in zip(counters, before)]
        want, batch, tracks_3d = fused_tail(model, *inputs, perm, ts, s, nq, (h, w))
    assert launched == {"default": [5, 3, 0, 0], "quantize": [5, 3, 28, 0],
                        "fused_block": [3, 3, 0, 2]}[knob]
    assert torch.equal(got["tracks"], want.tracks) and torch.equal(got["tracks_3d"], tracks_3d)
    assert torch.equal(got["query_points"], batch["query_points"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 151, 151, 8, 96, True), (1, 128, 2048, 8, 96, False),
                                   (16, 150, 150, 8, 64, True)])
def test_fused_attention_fn_backward_matches_plain_version(cuda_device, shape):
    """The kernel forward against ``attention_reference``; the backward kernel's
    dq, dk, dv against ``attention_backward_reference`` on the same inputs,
    within 2e-2 of each gradient's largest value; dq is zero on the fully
    masked item."""
    q, k, v, mask = _inputs(cuda_device, *shape)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    g = torch.randn(q.shape, device=cuda_device)
    before = fused_masked_attention.launches
    out = fused_attention_fn(q, k, v, mask)
    assert fused_masked_attention.launches == before + 1 and out.dtype == torch.float32
    torch.testing.assert_close(out, attention_reference(q.detach(), k.detach(), v.detach(), mask),
                               atol=ATOL, rtol=0)
    before = attention_backward.launches
    got = torch.autograd.grad(out, (q, k, v), g)
    assert attention_backward.launches == before + 1
    want = attention_backward_reference(q.detach(), k.detach(), v.detach(), mask, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2 * b.float().abs().max().item(),
                                   rtol=0)
    if mask is not None:
        assert got[0][0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (3, 300, 9, 2, 64, True), (3, 5, 9, 2, 8, True), (2, 77, 1000, 8, 128, True),
    (4, 33, 170, 2, 40, False),
    # The one-item limit (192 query rows and keys at D <= 96) and the first
    # chunked shape past it.
    (2, 192, 192, 2, 96, True), (2, 193, 193, 2, 96, True),
    # B H below the card's 132 SMs and not a multiple of them: the persistent
    # grid's last wave; a fully masked item at D = 96.
    (5, 151, 151, 7, 96, True), (25, 151, 151, 8, 64, True),
    # The latents' cross-attention: the row-statistics pass over 2048 keys.
    (2, 128, 2048, 8, 96, False)])
def test_attention_backward_kernel_chunks_and_widths(cuda_device, shape):
    """The backward kernel where it splits the queries (S > 192, or > 128 at
    D > 96: dk, dv summed over chunks) or the keys (K > 192: row statistics
    merged over chunks, dq summed over chunks), at the one-item limit, on a
    partial last wave, at head widths 8, 40, 64, 96 and 128; deterministic,
    dq zero on a fully masked item, and only the gradients asked for."""
    q, k, v, mask = _inputs(cuda_device, *shape)
    g = torch.randn(q.shape, device=cuda_device)
    got = attention_backward(q, k, v, mask, g)
    want = attention_backward_reference(q, k, v, mask, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2 * b.float().abs().max().item(),
                                   rtol=0)
    if mask is not None:
        assert got[0][0].abs().max().item() == 0.0
    assert all(torch.equal(a, b) for a, b in zip(got, attention_backward(q, k, v, mask, g)))
    dq, dk, dv = attention_backward(q, k, v, mask, g, needs=(False, True, False))
    assert dq is None and dv is None and torch.equal(dk, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 151, 151, 8, 96, True), (512, 129, 129, 8, 96, False),
                                   (512, 150, 150, 8, 64, True)])
def test_attention_backward_kernel_repeats_bit_for_bit_at_training_shapes(cuda_device, shape):
    """At the training step's encoder and readout shapes (2 x 256 tracks a
    chunk) each work item owns its (item, head) whole: no atomics and no
    partial sums, so two calls give the same bits (the sharded step's
    equality with the single-device one rests on it)."""
    q, k, v, mask = _inputs(cuda_device, *shape, seed=3)
    g = torch.randn(q.shape, device=cuda_device)
    first = attention_backward(q, k, v, mask, g)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(first, attention_backward(q, k, v, mask, g)))


@pytest.mark.cuda
def test_tiny_train_step_runs_the_kernel(cuda_device):
    """One bf16 train step with chunks and the kernel: each chunk's layer
    launches forward and again in the recompute; the loss is finite and
    within 1e-2 of the plain-attention model's on the same parameters."""
    from tdspa_torch.train.step import loss_and_grads
    from tdspa_torch.utils.testing import tiny_model_2d

    knobs = dict(dtype=torch.bfloat16, encoder_scan_chunk_size=4, decoder_scan_chunk_size=2)
    fused = tiny_model_2d(12, device=cuda_device, fused_attention=True, **knobs)
    plain = tiny_model_2d(12, device=cuda_device, **knobs)
    plain.load_state_dict(fused.state_dict())
    batch = to_torch(synthetic_batch(0, num_coords=2), cuda_device)
    before = fused_masked_attention.launches
    losses, grads = loss_and_grads(fused, dict(fused.named_parameters()), batch)
    # Encoder 2 chunks, latents self + cross, decoder 2 chunks x (decompress
    # + readout); the chunks again in the recompute.
    assert fused_masked_attention.launches - before == 2 * 2 + 2 + 2 * 2 * 2
    want, _ = loss_and_grads(plain, dict(plain.named_parameters()), batch)
    loss = losses["total_loss"].item()
    assert torch.isfinite(torch.tensor(loss)) and all(torch.isfinite(x).all() for x in grads)
    assert abs(loss / want["total_loss"].item() - 1) <= 1e-2


@pytest.mark.cuda
def test_tiny_model_runs_the_kernel_and_matches_the_plain_path(cuda_device):
    fused = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16, fused_attention=True)
    plain = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    batch = to_torch(synthetic_batch(0, with_features=True), cuda_device)
    before = fused_masked_attention.launches
    with torch.inference_mode():
        got, want = fused(batch), plain(batch)
    # One layer per stack: encoder, latent self + cross, decompress, readout.
    assert fused_masked_attention.launches - before == 5
    scale = want.tracks.abs().max().item()
    for name in ("tracks", "visible_logits"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=5e-2 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1297, 1297, 12), (2, 1370, 1370, 12), (2, 77, 1000, 4),
                                   (3, 200, 129, 2), (1, 1, 1, 1), (2, 300, 77, 3),
                                   (1, 128, 256, 2)])
def test_vit_kernel_matches_plain_version(cuda_device, shape):
    """The maskless ViT kernel (head width 64): the main-path frames, S and K
    not multiples of its 128-row block and 128-key tile, K below one tile,
    and both exact multiples. Rows past a frame's S or K must not see the
    next frame's tokens."""
    from tdspa_torch.kernels.attention import vit_attention

    batch, seq, kv_len, heads = shape
    q, k, v, _ = _inputs(cuda_device, batch, seq, kv_len, heads, 64, False)
    for out_dtype, rtol in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)):
        vit_before, fused_before = vit_attention.launches, fused_masked_attention.launches
        got = vit_attention(q, k, v, out_dtype=out_dtype)
        assert vit_attention.launches == vit_before + 1
        assert fused_masked_attention.launches == fused_before  # counted apart
        want = attention_reference(q, k, v, None, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=rtol)


@pytest.mark.cuda
def test_vit_kernel_refuses_what_it_does_not_take(cuda_device):
    from tdspa_torch.kernels.attention import vit_attention

    q, k, v, _ = _inputs(cuda_device, 1, 4, 4, 2, 64, False)
    with pytest.raises(NotImplementedError, match="forward-only"):
        vit_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(TypeError, match="bf16"):
        vit_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="D = 64"):
        vit_attention(*(_inputs(cuda_device, 1, 4, 4, 1, 96, False)[:3]))
    with pytest.raises(ValueError, match="contiguous"):
        vit_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


@pytest.mark.cuda
def test_tiny_vit_runs_the_kernel_and_matches_the_plain_path(cuda_device):
    """A 2-layer bf16 ViT of head width 64: one launch per layer, and within
    5e-2 of the output range of the same weights on the plain path."""
    from tdspa_torch.core.layers import init_parameters
    from tdspa_torch.features.vit import Dinov2, ViTConfig
    from tdspa_torch.kernels.attention import vit_attention

    config = ViTConfig(hidden_size=128, num_layers=2, num_heads=2, image_size=56)
    fused = Dinov2(config, dtype=torch.bfloat16, device=cuda_device)
    init_parameters(fused, 0, cuda_device)
    plain = Dinov2(config, dtype=torch.bfloat16, use_fused=False, device=cuda_device)
    plain.load_state_dict(fused.state_dict())
    img = torch.randn((3, 70, 84, 3), generator=torch.Generator(cuda_device).manual_seed(1),
                      device=cuda_device)
    before = vit_attention.launches
    with torch.inference_mode():
        got, want = fused(img), plain(img)
    assert vit_attention.launches - before == 2
    torch.testing.assert_close(got, want, atol=5e-2 * want.abs().max().item(), rtol=0)


LK_CONFIGS = [dict(fb_threshold=-1.0, iterations=3), dict(fb_threshold=2.0, iterations=4),
              dict(corr_radius=4, corr_rescue_level=2), dict(input_scale=0.5),
              dict(window=5, corr_radius=2), dict(window=8, fb_threshold=-1.0, iterations=3)]


def _border_queries(height, width):
    """The scene's grid plus points on, near and just inside each edge and
    corner, so that windows take the kernel's clamped path as well as its
    interior one at every level."""
    import numpy as np

    from tdspa_torch.features.tracks import make_query_grid

    xs = [0.0, 0.6, 2.5, 3.99, width / 2 + 0.3, width - 4.5, width - 1.4, width - 1.0]
    ys = [0.0, 1.2, 3.5, height / 2 + 0.7, height - 3.2, height - 1.0]
    edge = np.array([(x, y) for x in xs for y in ys], np.float32)
    return np.concatenate([make_query_grid(height, width, 10), edge])


@pytest.mark.cuda
@pytest.mark.parametrize("config", range(len(LK_CONFIGS)))
def test_lk_kernel_matches_plain_version(cuda_device, config):
    """Tolerance as in chip_smoke.py: 0.05 px on 99 % of (point, frame) pairs
    and 99 % visibility agreement (thresholded decisions on f32 sums). The
    scene pans, so tracks reach and leave the border, and samplings take both
    the kernel's interior path and its clamped one: the four configurations
    of chip_smoke.py, then window 5 (one pixel per lane, with the cost
    volume) and window 8 (an even window: taps between pixels)."""
    from tdspa_torch.kernels.lk import track_video_lk_kernel
    from tdspa_torch.ops.lk import track_video_lk
    from tdspa_torch.utils.synthetic_video import make_tracking_scene

    video, _, _ = make_tracking_scene(num_frames=12, height=96, width=128, grid_size=10,
                                      pan=(3, -2))
    v = torch.from_numpy(video).to(cuda_device)
    queries = _border_queries(96, 128)
    before = track_video_lk_kernel.launches
    got = track_video_lk_kernel(v, queries, return_velocity=True, **LK_CONFIGS[config])
    torch.cuda.synchronize()
    assert track_video_lk_kernel.launches == before + 1
    want = track_video_lk(v, queries, return_velocity=True, **LK_CONFIGS[config])
    err = (got[0] - want[0]).abs().amax(-1)
    assert (err <= 0.05).float().mean() >= 0.99
    assert (got[1] == want[1]).float().mean() >= 0.99
    with pytest.raises(ValueError, match="window"):
        track_video_lk_kernel(v, queries, window=13)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 16, 32])
@pytest.mark.parametrize("m", [1, 4])
def test_matcher_kernel_matches_plain_version(cuda_device, dim, m):
    """Tolerance 1e-4: both f32 with the same corner clamps and weights; the
    kernel contracts each window pixel with the templates before it blends
    (the plain version blends, then contracts). Points inside, on and past
    each border and corner, and far outside; radius 4 (fixed at compile
    time) and 3."""
    from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference

    gen = torch.Generator(device=cuda_device).manual_seed(dim + m)
    feats = torch.nn.functional.normalize(
        torch.randn((6, 40, 48, dim), generator=gen, device=cuda_device), dim=-1)
    tvecs = torch.nn.functional.normalize(
        torch.randn((41, m, dim), generator=gen, device=cuda_device), dim=-1)
    pos = torch.rand((41, 6, 2), generator=gen, device=cuda_device) * 60 - 6
    edges = torch.tensor([[0.0, 0.0], [47.0, 39.0], [-0.5, 20.3], [47.6, 12.1], [20.2, -3.7],
                          [11.1, 39.4], [-1e9, 5.0], [1e9, 1e9], [0.99999994, 38.99999]],
                         device=cuda_device)
    pos[: edges.shape[0], 0] = edges
    before = cost_patches_multi.launches
    got = cost_patches_multi(feats, tvecs, pos, 4)
    torch.cuda.synchronize()
    assert cost_patches_multi.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, cost_patches_reference(feats, tvecs, pos, 4), atol=1e-4, rtol=0)
    # Another radius takes the kernel's runtime-radius path.
    torch.testing.assert_close(cost_patches_multi(feats, tvecs, pos, 3),
                               cost_patches_reference(feats, tvecs, pos, 3), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="radius"):
        cost_patches_multi(feats, tvecs, pos, 9)


@pytest.mark.cuda
def test_tracker_on_the_gpu_launches_both_kernels(cuda_device):
    """The default policy on a degraded scene: one LK launch and the
    matcher's eight cost-patch launches (2 + 2 per refinement, twice)."""
    from tdspa_torch.features.tracks import PyramidalLKTracker
    from tdspa_torch.kernels.lk import track_video_lk_kernel
    from tdspa_torch.kernels.matcher import cost_patches_multi
    from tdspa_torch.utils.synthetic_video import make_tracking_scene

    video, _, _ = make_tracking_scene(num_frames=12, height=96, width=128, grid_size=8,
                                      noise_sigma=16.0, seed=1)
    tracker = PyramidalLKTracker(grid_size=8, fb_threshold=-1.0, iterations=3, matcher="auto")
    lk_before, m_before = track_video_lk_kernel.launches, cost_patches_multi.launches
    out = tracker(video)
    torch.cuda.synchronize()
    assert tracker.tiers["matcher"] is True
    assert track_video_lk_kernel.launches - lk_before == 1
    assert cost_patches_multi.launches - m_before == 8
    assert out["tracks"].is_cuda and out["tracks"].shape == (64, 12, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 384, 768, torch.float32),
                                   (1111, 1152, 2048, torch.float32),
                                   (4100, 1536, 384, torch.bfloat16), (3, 16, 8, torch.float32),
                                   (70, 48, 40, torch.bfloat16), (257, 3072, 200, torch.float32),
                                   (4100, 256, 520, torch.float32)])
def test_quant_kernel_equals_plain_version(cuda_device, shape):
    """Bit for bit: the same quantised values and exact integer sums, then the
    same two f32 products (as in chip_smoke.py). M not a multiple of the
    128-row tile, K = 16 (less than one 128-byte stage) and K = 3072, N = 8
    and N not a multiple of the tile width at BN = 64 (200) and BN = 128
    (520 with 33 row tiles)."""
    from tdspa_torch.kernels import quant_matmul as qmm

    m, k, n, dtype = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (3.0 * torch.randn((m, k), generator=gen, device=cuda_device)).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * 0.05
    before = qmm.quant_matmul.launches
    got = qmm.quant_matmul(x, w)
    torch.cuda.synchronize()
    assert qmm.quant_matmul.launches == before + 1
    assert torch.equal(got, qmm.quant_matmul_reference(x, w))
    xq, sx = qmm.quantize_rows(x)  # the quantise pass alone: the plain quantiser's values
    want_q, want_s = qmm.dynamic_int8(x.float(), -1)
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s.reshape(-1))
    with pytest.raises(ValueError, match="multiple of 16"):
        qmm.quant_matmul(x[:, :8].contiguous(), w[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 129, 1280, 8, 96, 1536), (1, 128, 1152, 8, 96, 2048),
                                   (3, 9, 64, 2, 32, 96), (2, 256, 256, 2, 128, 64),
                                   (5, 17, 128, 4, 64, 40), (2, 33, 200, 3, 96, 328),
                                   (3, 193, 384, 4, 96, 512), (7, 1, 128, 2, 64, 64)])
def test_block_kernel_matches_plain_version(cuda_device, shape):
    """Tolerance as in chip_smoke.py: 2e-2 abs (a bf16 rounding of an
    intermediate may land one step away; f32 summation order). The readout
    and decompress layers, a bf16 x, and widths that are not multiples of
    the GEMM's N tile: C = 200, MLP = 40 and 328, and 3 heads of 96 (864
    Q/K/V columns: a last tile of 96 in a 192-wide tile). The attention
    stage's edges: S = 193 (a fourth 64-row query slab on the first consumer
    warpgroup, one buffer), S = 256 with heads of 128, and S = 1."""
    from tdspa_torch.core.attention import ParallelTransformerBlock, reset_parameters
    from tdspa_torch.kernels.block import _operands, block_reference, fused_transformer_block

    items, seq, width, heads, head_dim, mlp = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    block = ParallelTransformerBlock(width, mlp, heads, heads * head_dim, fused_block=True,
                                     device=cuda_device)
    reset_parameters(block, gen)
    with torch.no_grad():
        for param in block.parameters():
            if param.dim() == 1:
                param.add_(0.1 * torch.randn(param.shape, generator=gen, device=cuda_device))
    x = torch.randn((items, seq, width), generator=gen, device=cuda_device)
    with torch.inference_mode():
        for x_in, out_dtype in ((x, torch.float32), (x.to(torch.bfloat16), torch.bfloat16)):
            before = fused_transformer_block.launches
            got = fused_transformer_block(x_in, block, heads, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert fused_transformer_block.launches == before + 1 and got.dtype == out_dtype
            want = block_reference(x_in, _operands(block), heads, out_dtype)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=0 if out_dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dino", "depth", "bf16_grid", "odd_channels"])
def test_bilinear_kernel_equals_plain_gather(cuda_device, case):
    from tdspa_torch.kernels.bilinear import bilinear_sample, bilinear_sample_reference
    from tdspa_torch.ops.geometry import bilinear_sample as tail_sample

    shape = {"dino": (6, 36, 36, 768), "depth": (6, 64, 80, 1), "bf16_grid": (4, 9, 7, 24),
             "odd_channels": (3, 7, 9, 5)}[case]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    grid = torch.randn(shape, generator=gen, device=cuda_device)
    if case == "bf16_grid":
        grid = grid.to(torch.bfloat16)
    t, h, w, _ = shape
    coords = torch.rand((300, t, 2), generator=gen, device=cuda_device)
    coords = coords * torch.tensor([w + 6.0, h + 6.0], device=cuda_device) - 3.0  # outside too
    before = bilinear_sample.launches
    got = tail_sample(grid, coords)
    torch.cuda.synchronize()
    assert bilinear_sample.launches == before + 1 and got.dtype == torch.float32
    assert torch.equal(got, bilinear_sample_reference(grid, coords))
    own = bilinear_sample(grid, coords)  # the TPU kernel's default: the grid's dtype
    assert own.dtype == grid.dtype and torch.equal(own, got.to(grid.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["quantize", "fused_block"])
def test_tiny_serving_models_run_their_kernels(cuda_device, knob):
    """One layer per stack: quantised, 28 int8 launches (4 blocks x 6 + the
    cross-attention's 4) and 5 attention launches; fused block (head width
    32), 2 block launches (decompress, readout) and 3 attention launches."""
    from tdspa_torch.kernels import quant_matmul as qmm
    from tdspa_torch.kernels.block import fused_transformer_block

    model = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16, fused_attention=True,
                          qkv_size=64, **{knob: True})
    plain = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16, fused_attention=True,
                          qkv_size=64)
    plain.load_state_dict(model.state_dict())
    batch = to_torch(synthetic_batch(0, with_features=True), cuda_device)
    counters = (fused_masked_attention, qmm.quant_matmul, fused_transformer_block)
    before = [fn.launches for fn in counters]
    with torch.inference_mode():
        got = model(batch)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    assert launched == ([5, 28, 0] if knob == "quantize" else [3, 0, 2])
    with torch.inference_mode():
        want = plain(batch)
    scale = want.tracks.abs().max().item()
    torch.testing.assert_close(got.tracks, want.tracks, atol=5e-2 * scale, rtol=0)


def _tiny_tail_inputs(device, n=16, t=12, h=24, w=24):
    gen = torch.Generator(device=device).manual_seed(0)
    tracks = torch.rand((n, t, 2), generator=gen, device=device) * (w - 1)
    visible = (torch.rand((n, t, 1), generator=gen, device=device) < 0.8).float()
    dino = torch.randn((t, 2, 2, 768), generator=gen, device=device)
    depth = 1.0 + torch.rand((t, h, w, 1), generator=gen, device=device)
    perm = torch.randperm(n, device=device)
    ts = torch.randint(0, t, (4,), device=device)
    return (tracks, visible, dino, depth), perm, ts, (8, 4, (h, w))


@pytest.mark.cuda
def test_debug_nans_names_the_kernel_op_on_the_gpu(cuda_device):
    """The tiny bf16 tail on the kernels: equal under the NaN check; a NaN in
    one DINO feature raised at the bilinear kernel's op."""
    from tdspa_torch.infer.pipeline import fused_tail
    from tdspa_torch.utils.profiling import debug_nans

    model = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16, fused_attention=True)
    args, perm, ts, shape = _tiny_tail_inputs(cuda_device)
    with torch.inference_mode():
        want, _, _ = fused_tail(model, *args, perm, ts, *shape)
        with debug_nans():
            got, _, _ = fused_tail(model, *args, perm, ts, *shape)
        torch.testing.assert_close(got.tracks, want.tracks, rtol=0, atol=0)
        args[2][:, :, :, 7] = float("nan")
        with debug_nans(), pytest.raises(FloatingPointError, match="tdspa.bilinear_sample"):
            fused_tail(model, *args, perm, ts, *shape)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_tail_equals_the_tail(cuda_device, tmp_path):
    """A one-rank NCCL group: the mesh tail equals ``fused_tail`` bit for bit
    with the same kernel launches (5 attention + 3 bilinear)."""
    import torch.distributed as dist

    from tdspa_torch.infer.pipeline import fused_tail, make_mesh_tail
    from tdspa_torch.kernels.bilinear import bilinear_sample
    from tdspa_torch.parallel.mesh import make_mesh

    model = tiny_model_3d(12, device=cuda_device, dtype=torch.bfloat16, fused_attention=True)
    args, perm, ts, (num_support, num_queries, hw) = _tiny_tail_inputs(cuda_device)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        tail = make_mesh_tail(make_mesh(), model, num_support, num_queries, hw)
        with torch.inference_mode():
            want, _, want_3d = fused_tail(model, *args, perm, ts, num_support, num_queries, hw)
            counts = [fused_masked_attention.launches, bilinear_sample.launches]
            got, _, got_3d = tail(*args, perm, ts)
            launched = [fused_masked_attention.launches - counts[0],
                        bilinear_sample.launches - counts[1]]
    finally:
        dist.destroy_process_group()
    assert launched == [5, 3]
    torch.testing.assert_close(got.tracks, want.tracks, rtol=0, atol=0)
    torch.testing.assert_close(got_3d, want_3d, rtol=0, atol=0)


NORM_WIDTHS = [(w, dt) for w in (256, 384, 512, 896, 1024, 1152, 1280)
               for dt in (torch.float32, torch.bfloat16)] + [(64, torch.bfloat16),
                                                             (96, torch.bfloat16)]


def _close_rows(got, want, rel, rtol):
    """Within ``rel`` of each row's largest value, plus ``rtol`` of each value
    (a bf16 output may round the other way: 2**-7)."""
    got, want = got.float(), want.float()
    atol = rel * want.abs().amax(dim=-1, keepdim=True)
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), f"{int(bad.sum())} values off; worst {(got - want).abs().max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("width,x_dtype", NORM_WIDTHS)
def test_row_norm_kernel_matches_plain_version(cuda_device, width, x_dtype):
    """``csrc/norm.cu`` forward (f32 and bf16 out) and backward (dx, dscale)
    against the plain versions on the card, centered and RMS, over 777 rows
    (no multiple of a block's rows), the first row zero (zero variance,
    r = 1000; a constant row of nonzero mean would be ill-conditioned, its
    fast variance being rounding): within f32 rounding of each row's largest
    value (1e-5), and a bf16 ulp where the output is bf16."""
    from tdspa_torch.kernels import norm

    gen = torch.Generator(device=cuda_device).manual_seed(width)
    x = (torch.randn((777, width), generator=gen, device=cuda_device) * 2 + 0.5).to(x_dtype)
    x[0] = 0.0
    scale = torch.rand(width, generator=gen, device=cuda_device) + 0.5
    for centered in (True, False):
        for out_dtype in (torch.float32, torch.bfloat16):
            rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
            before = norm.row_norm.launches
            with torch.inference_mode():
                got = norm.row_norm(x, scale, centered, out_dtype)
            torch.cuda.synchronize()
            assert norm.row_norm.launches == before + 1 and got.dtype == out_dtype
            _close_rows(got, norm.row_norm_reference(x, scale, centered, out_dtype), 1e-5, rtol)

            dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(out_dtype)
            before = norm.row_norm_backward.launches
            dx, dscale = norm.row_norm_backward(x, scale, dy, centered)
            torch.cuda.synchronize()
            assert norm.row_norm_backward.launches == before + 1
            want_dx, want_dscale = norm.row_norm_backward_reference(x, scale, dy, centered)
            assert dx.dtype == x_dtype and dscale.dtype == torch.float32
            _close_rows(dx, want_dx, 1e-5, 2.0 ** -7 if x_dtype == torch.bfloat16 else 1e-5)
            torch.testing.assert_close(dscale, want_dscale, rtol=1e-4,
                                       atol=1e-4 * want_dscale.abs().max().item())
            again = norm.row_norm_backward(x, scale, dy, centered)
            assert torch.equal(again[0], dx) and torch.equal(again[1], dscale)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("cotangents", [1, 2, 3, 4])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [96, 256, 384, 1024, 1280])
def test_row_norm_backward_sums_its_cotangents(cuda_device, width, x_dtype, cotangents):
    """The backward kernel with 1 to 4 bf16 cotangents (a shared norm's
    readers) against ``row_norm_backward_reference`` of their f32 sum, centered
    and RMS, over 777 rows, the first zero: within f32 rounding of each row's
    largest value, a bf16 ulp where dx is bf16; bit-equal from run to run."""
    from tdspa_torch.kernels import norm

    gen = torch.Generator(device=cuda_device).manual_seed(width + cotangents)
    x = (torch.randn((777, width), generator=gen, device=cuda_device) * 2 + 0.5).to(x_dtype)
    x[0] = 0.0
    scale = torch.rand(width, generator=gen, device=cuda_device) + 0.5
    dys = [torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
           for _ in range(cotangents)]
    for centered in (True, False):
        before = norm.row_norm_backward.launches
        dx, dscale = norm.row_norm_backward(x, scale, dys, centered)
        torch.cuda.synchronize()
        assert norm.row_norm_backward.launches == before + 1
        want_dx, want_dscale = norm.row_norm_backward_reference(
            x, scale, norm.cotangent_sum(dys), centered)
        assert dx.dtype == x_dtype and dscale.dtype == torch.float32
        _close_rows(dx, want_dx, 1e-5, 2.0 ** -7 if x_dtype == torch.bfloat16 else 1e-5)
        torch.testing.assert_close(dscale, want_dscale, rtol=1e-4,
                                   atol=1e-4 * want_dscale.abs().max().item())
        again = norm.row_norm_backward(x, scale, dys, centered)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dscale)


@pytest.mark.cuda
@pytest.mark.parametrize("cotangents", [1, 3])
def test_row_norm_backward_sums_bf16_cotangents_off_the_8_value_vector(cuda_device, cotangents):
    """f32 rows of 100 values (no multiple of 8) with bf16 cotangents take
    x's own 4-value vectors, each cotangent in 8-byte words: against the
    plain backward of their f32 sum."""
    from tdspa_torch.kernels import norm

    gen = torch.Generator(device=cuda_device).manual_seed(cotangents)
    x = torch.randn((513, 100), generator=gen, device=cuda_device) * 2 + 0.5
    scale = torch.rand(100, generator=gen, device=cuda_device) + 0.5
    dys = [torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
           for _ in range(cotangents)]
    assert norm.backward_plan(100, 4, 2) == norm.plan(100, 4)
    for centered in (True, False):
        dx, dscale = norm.row_norm_backward(x, scale, dys, centered)
        want_dx, want_dscale = norm.row_norm_backward_reference(
            x, scale, norm.cotangent_sum(dys), centered)
        _close_rows(dx, want_dx, 1e-5, 1e-5)
        torch.testing.assert_close(dscale, want_dscale, rtol=1e-4,
                                   atol=1e-4 * want_dscale.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True])
def test_block_shared_query_norm_matches_todays_chain_on_the_card(cuda_device, cross):
    """A bf16 block with an f32 residual under autograd on the card: one
    shared forward launch for ``norm_q`` and one backward summing its 3 (4)
    readers' cotangents; every gradient against the chain it replaced (f32
    norms, one cast a projection) on the same card, within 1e-2 of each
    gradient's largest value: the norms' backward sums a row in another f32
    order, and the bf16 GEMMs behind it may round that the other way (up to
    3.6e-3 of the largest value seen, one bf16 ulp), where a cotangent
    missing or summed twice moves a gradient by its own size; the output
    bit for bit."""
    from tdspa_torch.core.attention import ParallelTransformerBlock, reset_parameters
    from tdspa_torch.kernels import norm

    block = ParallelTransformerBlock(256, 512, 2, 192, kv_width=128 if cross else None,
                                     dtype=torch.bfloat16, use_fused=True, device=cuda_device)
    reset_parameters(block, torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((3, 64, 256), generator=gen, device=cuda_device)
    kv = torch.randn((3, 40, 128), generator=gen, device=cuda_device) if cross else None

    def todays(a, b):
        normed = block.norm_q(a)
        out = a + block.self_att(normed, normed)
        if b is not None:
            out = out + block.cross_att(normed, b)
        h = torch.nn.functional.gelu(block.MLP_in(block.norm_attn(out)),
                                     approximate="tanh")
        return out + block.MLP_out(h).float()

    outs, grads = [], []
    counts = (norm.row_norm_shared.launches, norm.row_norm_shared.cotangents)
    for forward in (block, todays):
        xs = x.clone().requires_grad_()
        out = forward(xs, kv)
        grads.append(torch.autograd.grad(out.square().mean(), [xs, *block.parameters()]))
        outs.append(out.detach())
    assert (norm.row_norm_shared.launches - counts[0],
            norm.row_norm_shared.cotangents - counts[1]) == (1, 4 if cross else 3)
    assert torch.equal(outs[0], outs[1]), (outs[0] - outs[1]).abs().max().item()
    names = ["x"] + [name for name, _ in block.named_parameters()]
    for name, got, want in zip(names, *grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * want.abs().max().item(),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_row_norm_kernel_copies_unaligned_operands_and_refuses_odd_widths(cuda_device):
    """Operands off a 16-byte boundary (x, and dy in the backward) are copied
    to aligned ones and give the plain result; widths that are no multiple
    of a 16-byte vector raise before any launch."""
    from tdspa_torch.kernels import norm

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    flat = torch.randn(301 * 64 + 2, generator=gen, device=cuda_device)
    x = flat[2:].view(301, 64)  # 8 bytes past the allocation's alignment
    dy = torch.randn(301 * 64 + 1, generator=gen, device=cuda_device)[1:].view(301, 64)
    scale = torch.rand(64, generator=gen, device=cuda_device) + 0.5
    with torch.inference_mode():
        got = norm.row_norm(x, scale, False, torch.bfloat16)
    _close_rows(got, norm.row_norm_reference(x, scale, False, torch.bfloat16), 1e-5, 2.0 ** -7)
    dx, dscale = norm.row_norm_backward(x, scale, dy, True)
    want_dx, want_dscale = norm.row_norm_backward_reference(x, scale, dy, True)
    _close_rows(dx, want_dx, 1e-5, 1e-5)
    torch.testing.assert_close(dscale, want_dscale, rtol=1e-4,
                               atol=1e-4 * want_dscale.abs().max().item())
    before = norm.row_norm.launches, norm.row_norm_backward.launches
    for width, x_dtype in ((12, torch.bfloat16), (7, torch.float32), (20, torch.bfloat16)):
        x = torch.randn((301, width), generator=gen, device=cuda_device).to(x_dtype)
        scale = torch.rand(width, generator=gen, device=cuda_device) + 0.5
        with pytest.raises(ValueError, match="a multiple of"), torch.inference_mode():
            norm.row_norm(x, scale, True, torch.float32)
        with pytest.raises(ValueError, match="a multiple of"):
            norm.row_norm_backward(x, scale, torch.ones_like(x), True)
    assert (norm.row_norm.launches, norm.row_norm_backward.launches) == before


@pytest.mark.cuda
def test_tiny_3dspa_forward_launches_one_row_norm_per_norm(cuda_device):
    """Tiny widths, the default stack depths 3/4/4/4: 72 launches, one a
    ``_Norm`` (3 x 4 + 1 encoder, 4 x 6 + 1 latents with their
    cross-attention, 4 x 4 + 1 decompress, 4 x 4 + 1 readout); in f32, the
    same model on the CPU (the eager chain) within 1e-4 of the range."""
    from tdspa_torch.kernels import norm

    depths = dict(input_track_layers=3, tracks_to_latents_layers=4, decompress_layers=4,
                  readout_layers=4)
    model = tiny_model_3d(12, device=cuda_device, **depths)
    cpu = tiny_model_3d(12, device="cpu", **depths)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = synthetic_batch(0, with_features=True)
    before = norm.row_norm.launches
    with torch.inference_mode():
        got = model(to_torch(batch, cuda_device))
        want = cpu(to_torch(batch, "cpu"))
    assert norm.row_norm.launches - before == 72
    for name in ("tracks", "visible_logits"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(got, name).cpu(), w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.cuda
def test_stack_gradients_through_the_norm_kernels_match_the_cpu(cuda_device):
    """An f32 two-layer stack with cross-attention (plain attention): loss and
    every parameter's gradient through the norm kernels (forward and backward)
    against the same stack on the CPU (the eager chain), 1e-4 of each
    gradient's largest value."""
    from tdspa_torch.core.attention import TransformerStack, reset_parameters
    from tdspa_torch.kernels import norm

    stack = TransformerStack(64, 64, 2, 96, 2, kv_width=48, device="cpu")
    reset_parameters(stack, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in stack.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x, kv = torch.randn((3, 40, 64), generator=gen), torch.randn((3, 17, 48), generator=gen)
    gpu = TransformerStack(64, 64, 2, 96, 2, kv_width=48, device=cuda_device)
    gpu.load_state_dict({k: v.to(cuda_device) for k, v in stack.state_dict().items()})
    losses, grads = [], []
    before = norm.row_norm_backward.launches
    for module, dev in ((stack, "cpu"), (gpu, cuda_device)):
        loss = module(x.to(dev), inputs_kv=kv.to(dev)).square().mean()
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, list(module.parameters())))
    assert norm.row_norm_backward.launches - before == 2 * 6 + 1
    assert abs(losses[1] / losses[0] - 1) < 1e-5
    for want, got in zip(*grads):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_tiny_train_step_runs_the_norm_backward(cuda_device):
    """One bf16 TRAJAN step: the norms' backward runs on the kernel (the remat
    recompute's forward norms too), the loss finite."""
    from tdspa_torch.kernels import norm
    from tdspa_torch.train.step import loss_and_grads
    from tdspa_torch.utils.testing import tiny_model_2d

    model = tiny_model_2d(12, device=cuda_device, fused_attention=True, dtype=torch.bfloat16)
    batch = to_torch(synthetic_batch(0, num_coords=2), cuda_device)
    before = norm.row_norm.launches, norm.row_norm_backward.launches
    losses, grads = loss_and_grads(model, dict(model.named_parameters()), batch)
    assert norm.row_norm.launches > before[0] and norm.row_norm_backward.launches > before[1]
    assert torch.isfinite(losses["total_loss"]) and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
def test_vitg_block_matches_the_plain_reference(cuda_device):
    """One DINOv2 ViT-g/14 block at its published width (1536, 24 heads of
    64, SwiGLU 4096) on 8 frames of 1297 tokens, as the extractor runs it
    (bf16 products, the ViT attention kernel, f32 residual), against the
    plain f32 reference ``tests/plain/dinov2.py`` (TF32 off), both on the
    checkpoint-named weights. The block's increment (output minus input) is
    compared: the worst token's gap within 2e-2 of the median token's norm,
    about 5 times what bf16 operands (2**-8 relative) in four chained
    products give."""
    from tdspa_torch.features.vit import Dinov2, ViTConfig, convert_hf_dinov2_params
    from tdspa_torch.infer.convert import params_from_flax
    from tdspa_torch.kernels.attention import vit_attention
    from tests.plain import dinov2 as plain

    config = ViTConfig.preset("vitg", num_layers=1)
    cfg = {"hidden_size": 1536, "num_hidden_layers": 1, "num_attention_heads": 24,
           "mlp_ratio": 4, "patch_size": 14, "image_size": 518, "layer_norm_eps": 1e-6,
           "use_swiglu_ffn": True}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = {}
    for name, shape in plain.state_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=cuda_device)
        if len(shape) == 1:
            x = 1.0 + 0.1 * x if name.endswith(("norm1.weight", "norm2.weight", "lambda1")) \
                else 0.1 * x
        elif name.endswith("weight"):
            x = x / shape[1] ** 0.5
        state[name] = x
    model = Dinov2(config, dtype=torch.bfloat16, residual_dtype=torch.float32,
                   device=cuda_device)
    model.load_state_dict(params_from_flax(convert_hf_dinov2_params(state, config)))
    x = torch.randn((8, 1297, 1536), generator=gen, device=cuda_device)
    before = vit_attention.launches
    with torch.inference_mode():
        got = model.layer_0(x)
    assert vit_attention.launches - before == 1
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            want = plain.block(state, 0, x, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert got.dtype == torch.float32
    gap = torch.linalg.vector_norm(got - want, dim=-1)
    worst = float(gap.max() / torch.linalg.vector_norm(want - x, dim=-1).median())
    assert worst < 2e-2, worst


def _ulps(got, want) -> int:
    """The largest distance between got and want in units in the last place
    of their dtype (bf16 or f32)."""
    bits, magnitude = {torch.bfloat16: (torch.int16, 0x7FFF),
                       torch.float32: (torch.int32, 0x7FFFFFFF)}[want.dtype]

    def line(t):  # sign and magnitude onto one integer line (-0 = +0)
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & magnitude), i)

    return int((line(got) - line(want)).abs().max())


# (rows, width, x dtype, h dtype): ViT-S/B/L/g widths over 777 rows (no
# multiple of a block's rows), ViT-g's full shape, 8 frames of 1297 tokens,
# and ViT-B's as the pipeline runs it: DINO's 8 x 1297 and the depth
# backbone's 8 x 1370 tokens.
VIT_ROW_SHAPES = [(777, w, x, h) for w in (384, 768, 1024, 1536)
                  for x, h in ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
                               (torch.bfloat16, torch.bfloat16))] + [
    (10376, 1536, torch.float32, torch.bfloat16), (10376, 768, torch.float32, torch.bfloat16),
    (10960, 768, torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,x_dtype,h_dtype", VIT_ROW_SHAPES)
def test_vit_residual_norm_kernel_matches_plain_version(cuda_device, rows, width, x_dtype,
                                                         h_dtype):
    """``csrc/vit_block.cu``'s row kernel against its plain version on the
    card, with and without the residual prologue, both norm dtypes: the
    stream x' equal bit for bit (built with --fmad=false); the norm within
    f32 rounding of each row's largest value (1e-5, the row's sums add in
    another order) plus a bf16 ulp where it is bf16. One launch a call."""
    from tdspa_torch.kernels import vit_block

    gen = torch.Generator(device=cuda_device).manual_seed(width)
    x = (torch.randn((rows, width), generator=gen, device=cuda_device) * 3 + 0.5).to(x_dtype)
    h = torch.randn((rows, width), generator=gen, device=cuda_device).to(h_dtype)
    bias, layer_scale, scale, norm_bias = (
        torch.randn(width, generator=gen, device=cuda_device) * 0.5 + 0.5 for _ in range(4))
    residual, norm = (h, bias, layer_scale), (scale, norm_bias, 1e-6)
    for out_dtype in (torch.float32, torch.bfloat16):
        rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
        before = vit_block.vit_residual_norm.launches
        with torch.inference_mode():
            got = vit_block.vit_residual_norm(x, norm=norm, out_dtype=out_dtype)
            got_x, got_both = vit_block.vit_residual_norm(x, residual, norm, out_dtype)
            got_res = vit_block.vit_residual_norm(x, residual)
        torch.cuda.synchronize()
        assert vit_block.vit_residual_norm.launches == before + 3
        want = vit_block.vit_residual_norm_reference(x, norm=norm, out_dtype=out_dtype)
        want_x, want_both = vit_block.vit_residual_norm_reference(x, residual, norm, out_dtype)
        assert got_x.dtype == x_dtype and torch.equal(got_x, want_x)
        assert torch.equal(got_res, want_x)
        _close_rows(got, want, 1e-5, rtol)
        _close_rows(got_both, want_both, 1e-5, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden,dtype", [(777, 128, torch.bfloat16),
                                               (777, 4096, torch.bfloat16),
                                               (777, 4096, torch.float32),
                                               (10376, 4096, torch.bfloat16)])
def test_swiglu_gate_kernel_matches_plain_version(cuda_device, rows, hidden, dtype):
    """The gate kernel against ``F.silu(y1) * y2`` on the biased halves (the
    plain version) on the card, ViT-g's full [10376, 8192] among the shapes:
    within one ulp of the dtype (the same roundings; only exp may differ)."""
    from tdspa_torch.kernels import vit_block

    gen = torch.Generator(device=cuda_device).manual_seed(hidden)
    y = (torch.randn((rows, 2 * hidden), generator=gen, device=cuda_device) * 2).to(dtype)
    bias = torch.randn(2 * hidden, generator=gen, device=cuda_device) * 0.5
    before = vit_block.swiglu_gate.launches
    with torch.inference_mode():
        got = vit_block.swiglu_gate(y, bias)
    want = vit_block.swiglu_gate_reference(y, bias)
    assert vit_block.swiglu_gate.launches == before + 1
    assert got.dtype == dtype and got.shape == (rows, hidden)
    assert _ulps(got, want) <= 1


@pytest.mark.cuda
def test_swiglu_gate_kernel_equals_f_silu_on_every_bf16_value(cuda_device):
    """The bf16 gate's SiLU (the fast intrinsics above -80, the exact path
    below) against ``F.silu`` for every finite bf16 value as the first half
    (bias 0, second half 1): equal bit for bit, so the kernel rounds as the
    eager chain does on any input."""
    from tdspa_torch.kernels import vit_block

    bits = torch.arange(-2 ** 15, 2 ** 15, device=cuda_device, dtype=torch.int32)
    values = bits.to(torch.int16).view(torch.bfloat16)
    values = values[torch.isfinite(values.float())]
    values = values[: values.numel() // 8 * 8].reshape(-1, 8)
    y = torch.cat([values, torch.ones_like(values)], dim=-1)
    bias = torch.zeros(16, device=cuda_device)
    with torch.inference_mode():
        got = vit_block.swiglu_gate(y, bias)
    want = vit_block.swiglu_gate_reference(y, bias)
    assert values.numel() > 65000
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1297, 1297, 24), (2, 77, 1000, 4)])
def test_vit_kernel_bf16_out_is_the_f32_out_rounded(cuda_device, shape):
    """``vit_attention`` writing bf16 (what the ViT block asks for) equals its
    f32 output cast to bf16 (what the block did before), bit for bit: both
    round the same f32 value once."""
    from tdspa_torch.kernels.attention import vit_attention

    q, k, v, _ = _inputs(cuda_device, *shape, 64, False)
    with torch.inference_mode():
        got = vit_attention(q, k, v, out_dtype=torch.bfloat16)
        want = vit_attention(q, k, v, out_dtype=torch.float32).to(torch.bfloat16)
    assert torch.equal(got, want)


def _seeded_vit(name, device, seed=0):
    from tdspa_torch.core.layers import init_parameters
    from tdspa_torch.features.vit import Dinov2, ViTConfig

    model = Dinov2(ViTConfig.preset(name), dtype=torch.bfloat16, residual_dtype=torch.float32,
                   device=device)
    init_parameters(model, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():  # biases, norms and layer scales away from their init
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
    return model


def _card_heads(att, q, k, v):
    """The attention's heads as the block took them before the kernels: the
    ViT kernel writing ``kernel_out_dtype`` (f32), then cast."""
    from tdspa_torch.kernels.attention import vit_attention

    out = vit_attention(*(t.to(torch.bfloat16).contiguous() for t in (q, k, v)),
                        out_dtype=att.kernel_out_dtype)
    return out.to(att.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name,row_launches,gate_launches", [("vitg", 3, 1), ("vitb", 3, 0)])
def test_full_width_vit_block_matches_the_eager_chain(cuda_device, name, row_launches,
                                                      gate_launches):
    """A ViT-g/14 (SwiGLU) and a ViT-B/14 (MLP) block at their published
    widths on 8 frames of 1297 tokens, bf16 products and an f32 stream, as the
    extractor runs them, against the block's code before the kernels
    (``tests/test_torch_vit_block.py::eager_block`` with the attention kernel
    writing f32) on the same weights: the worst token's gap within 1e-2 of
    the median token's increment. The kernels' norms may round an element a
    bf16 ulp the other way; everything else is the same arithmetic."""
    from tdspa_torch.kernels import vit_block
    from tests.test_torch_vit_block import eager_block

    model = _seeded_vit(name, cuda_device)
    block = model.layer_0
    x = torch.randn((8, 1297, model.config.hidden_size),
                    generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    before = vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches
    with torch.inference_mode():
        got = block(x)
        counts = (vit_block.vit_residual_norm.launches - before[0],
                  vit_block.swiglu_gate.launches - before[1])
        want = eager_block(block, x, heads=_card_heads)
    assert counts == (row_launches, gate_launches)
    assert got.dtype == want.dtype == torch.float32
    gap = torch.linalg.vector_norm(got - want, dim=-1)
    worst = float(gap.max() / torch.linalg.vector_norm(want - x, dim=-1).median())
    assert worst < 1e-2, worst


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,gates,attentions", [("vitg", 121, 40, 40),
                                                        ("vitb", 37, 0, 12)])
def test_vit_forward_launch_counts(cuda_device, name, rows, gates, attentions):
    """One 8-frame forward (504 x 504, 1297 tokens a frame, as the extractor
    batches them): three row launches a block and the final norm, one gate a
    SwiGLU block, one attention a block; a finite f32 output."""
    from tdspa_torch.kernels import vit_block
    from tdspa_torch.kernels.attention import vit_attention

    model = _seeded_vit(name, cuda_device)
    pixels = torch.randn((8, 504, 504, 3), generator=torch.Generator(device=cuda_device)
                         .manual_seed(2), device=cuda_device)
    before = (vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches,
              vit_attention.launches)
    with torch.inference_mode():
        out = model(pixels)
    after = (vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches,
             vit_attention.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (rows, gates, attentions)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.cuda
def test_depth_backbone_taps_match_the_eager_chain(cuda_device):
    """The depth estimator's ViT-B/14 backbone with its taps (blocks 2, 5, 8,
    11) on 8 frames of 518 x 518 (37 x 37 patches + CLS), through the
    kernels: 37 row launches and no gate; each tap is its block's output in
    the f32 stream, bit for bit; each block against the eager chain on the
    input it was given (the worst token's gap within 1e-2 of the median
    token's increment, as the full-width block test); the output within f32
    rounding of the final norm's plain version on the last block's output."""
    from tdspa_torch.features.vit import _norm_args
    from tdspa_torch.kernels import vit_block
    from tests.test_torch_vit_block import eager_block

    model = _seeded_vit("vitb", cuda_device)
    taps = (2, 5, 8, 11)
    seen = {}
    hooks = [getattr(model, f"layer_{i}").register_forward_hook(
        lambda module, args, out, i=i: seen.__setitem__(i, (args[0], out)))
        for i in range(model.config.num_layers)]
    pixels = torch.rand((8, 518, 518, 3), generator=torch.Generator(device=cuda_device)
                        .manual_seed(3), device=cuda_device)
    before = vit_block.vit_residual_norm.launches, vit_block.swiglu_gate.launches
    with torch.inference_mode():
        out, tapped = model(pixels, taps=taps)
    counts = (vit_block.vit_residual_norm.launches - before[0],
              vit_block.swiglu_gate.launches - before[1])
    for hook in hooks:
        hook.remove()
    assert counts == (37, 0)
    assert [t.shape for t in tapped] == [torch.Size([8, 1370, 768])] * len(taps)
    for i, t in zip(taps, tapped):
        assert t.dtype == torch.float32 and torch.equal(t, seen[i][1])
    with torch.inference_mode():
        for i in range(model.config.num_layers):
            x, got = seen[i]
            want = eager_block(getattr(model, f"layer_{i}"), x, heads=_card_heads)
            gap = torch.linalg.vector_norm(got - want, dim=-1)
            worst = float(gap.max() / torch.linalg.vector_norm(want - x, dim=-1).median())
            assert worst < 1e-2, (i, worst)
        final = vit_block.vit_residual_norm_reference(
            seen[model.config.num_layers - 1][1], norm=_norm_args(model.layernorm),
            out_dtype=torch.float32)
    _close_rows(out, final, 1e-5, 0.0)
