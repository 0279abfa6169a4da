"""The port's CUDA kernels on a GPU (marked ``cuda``; skip without a GPU).

Imports no JAX, so it also runs on a GPU host that has none (the repository's
``conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version as in ``tests/test_torch_attention.py``
(2e-2 abs, + 2**-7 rel for a bf16 output), for both attention kernels; the
tiny bf16 model or ViT with the kernel vs the same one with the plain
attention path, 5e-2 of the output range (the two round differently inside
every attention).
"""

import pytest
import torch

from tdspa_torch.kernels.attention import attention_reference, fused_masked_attention
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
def test_kernel_refuses_inputs_that_require_grad(cuda_device):
    q, k, v, _ = _inputs(cuda_device, 1, 4, 4, 1, 8, False)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_masked_attention(q.requires_grad_(), k, v)


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
                                   (3, 200, 129, 2), (1, 1, 1, 1)])
def test_vit_kernel_matches_plain_version(cuda_device, shape):
    """The maskless ViT kernel (head width 64): the main-path frames, K not a
    multiple of its 64-key tile, S not a multiple of its 128-row block."""
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
              dict(corr_radius=4, corr_rescue_level=2), dict(input_scale=0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("config", range(len(LK_CONFIGS)))
def test_lk_kernel_matches_plain_version(cuda_device, config):
    """Tolerance as in chip_smoke.py: 0.05 px on 99 % of (point, frame) pairs
    and 99 % visibility agreement (thresholded decisions on f32 sums)."""
    from tdspa_torch.features.tracks import make_query_grid
    from tdspa_torch.kernels.lk import track_video_lk_kernel
    from tdspa_torch.ops.lk import track_video_lk
    from tdspa_torch.utils.synthetic_video import make_tracking_scene

    video, _, _ = make_tracking_scene(num_frames=12, height=96, width=128, grid_size=10)
    v = torch.from_numpy(video).to(cuda_device)
    queries = make_query_grid(96, 128, 10)
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
@pytest.mark.parametrize("m", [1, 4])
def test_matcher_kernel_matches_plain_version(cuda_device, m):
    """Tolerance 1e-4: both f32 with the same corner clamps; the kernel forms
    the bilinear weights and the 16-term dot product in another order."""
    from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    feats = torch.nn.functional.normalize(
        torch.randn((6, 40, 48, 16), generator=gen, device=cuda_device), dim=-1)
    tvecs = torch.nn.functional.normalize(
        torch.randn((37, m, 16), generator=gen, device=cuda_device), dim=-1)
    pos = torch.rand((37, 6, 2), generator=gen, device=cuda_device) * 60 - 6  # borders too
    before = cost_patches_multi.launches
    got = cost_patches_multi(feats, tvecs, pos, 4)
    torch.cuda.synchronize()
    assert cost_patches_multi.launches == before + 1
    torch.testing.assert_close(got, cost_patches_reference(feats, tvecs, pos, 4), atol=1e-4, rtol=0)


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
