"""tdspa_torch.features.{vit,dino} and ops.resize against tdspa's: the
DINOv2 encoder, its position-embedding interpolation, the extractor's
preprocess and frame grouping, the HF converter, and the resizes.

A tiny ViT (hidden 32, 2 heads, patch 14, native 28x28 as in
tests/unit/test_depth.py) with a perturbed JAX parameter tree carried across
by ``params_from_flax``. Tolerances: f32 on both sides, sums in another
order: 2e-5 abs on tokens of unit scale (LayerNorm output); resizes 2e-6
(weights built by the same formula, two f32 contractions); the converter
copies arrays, so its trees are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.features import dino as jax_dino
from tdspa.features.vit import Dinov2Flax, ViTConfig as JaxViTConfig
from tdspa.features.vit import convert_hf_dinov2_params as jax_convert_hf
from tdspa.features.vit import interpolate_pos_embed as jax_interpolate
from tdspa_torch.features.dino import DinoFeatureExtractor
from tdspa_torch.features.vit import Dinov2, ViTConfig, convert_hf_dinov2_params
from tdspa_torch.features.vit import interpolate_pos_embed
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.ops.resize import resize, resize_align_corners

F32_TOL = dict(rtol=2e-5, atol=2e-5)
RESIZE_TOL = dict(rtol=0, atol=2e-6)
TINY = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, image_size=28)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), tree)


def _tiny_flax(seed=0):
    model = Dinov2Flax(config=JaxViTConfig(**TINY))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)))["params"]
    return model, _perturbed(params, seed)


def _tiny_port(params):
    model = Dinov2(ViTConfig(**TINY), device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.mark.parametrize("side", [28, 56], ids=["native", "interpolated"])
def test_tiny_vit_matches_flax(side):
    """Native 2x2 patch grid, and 4x4 (bicubic position embeddings)."""
    flax_model, params = _tiny_flax()
    model = _tiny_port(params)
    img = np.random.default_rng(1).standard_normal((3, side, side + 14, 3)).astype(np.float32)
    want = flax_model.apply({"params": params}, jnp.asarray(img))
    want_grid = flax_model.apply({"params": params}, jnp.asarray(img),
                                 method=flax_model.patch_grid)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
        got_grid = model.patch_grid(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_grid.numpy(), np.asarray(want_grid), **F32_TOL)


def test_vit_knobs_match_flax():
    """bf16 residual stream and tanh GELU, f32 compute (CPU: XLA path)."""
    config = JaxViTConfig(**TINY)
    _, params = _tiny_flax(2)
    flax_model = Dinov2Flax(config=config, residual_dtype=jnp.bfloat16, gelu_approximate=True)
    model = Dinov2(ViTConfig(**TINY), residual_dtype=torch.bfloat16, gelu_approximate=True,
                   device="cpu")
    model.load_state_dict(params_from_flax(params))
    img = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(img)))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    # bf16 residual: both round the stream to bf16 (2**-8 relative) at
    # different points of their fused elementwise chains.
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert np.abs(got - want).mean() < 5e-3


@pytest.mark.parametrize("new_hw", [(3, 5), (1, 1), (2, 2)])
def test_interpolate_pos_embed_matches_jax(new_hw):
    pos = np.random.default_rng(4).standard_normal((1, 1 + 16, 8)).astype(np.float32)
    want = jax_interpolate(jnp.asarray(pos), *new_hw)
    got = interpolate_pos_embed(torch.from_numpy(pos), *new_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw,method", [
    ((2, 512, 512, 3), (504, 504), "bilinear"),  # DINO preprocess
    ((2, 64, 48, 3), (70, 56), "bilinear"),  # depth input (upsampling)
    ((2, 70, 56, 1), (64, 48), "bilinear"),  # depth output
    ((1, 37, 37, 4), (36, 36), "bicubic"),  # DINO position embeddings
    ((1, 5, 7, 2), (9, 3), "bicubic"),
])
def test_resize_matches_jax_image_resize(shape, out_hw, method):
    x = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape[:1] + out_hw + shape[3:], method=method)
    got = resize(torch.from_numpy(x), out_hw, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RESIZE_TOL)


@pytest.mark.parametrize("out_hw", [(9, 13), (5, 6), (1, 4)])
def test_resize_align_corners_matches_jax(out_hw):
    from tdspa.features.depth import _resize_align_corners

    x = np.random.default_rng(6).standard_normal((2, 5, 6, 3)).astype(np.float32)
    want = _resize_align_corners(jnp.asarray(x), out_hw)
    got = resize_align_corners(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.fixture
def tiny_jax_extractor(monkeypatch):
    """The JAX extractor, its preset swapped for the tiny ViT."""
    monkeypatch.setattr(jax_dino.ViTConfig, "preset",
                        classmethod(lambda cls, name, **kw: cls(**TINY)))
    _, params = _tiny_flax()
    return jax_dino.DinoFeatureExtractor(params=params, dtype=jnp.float32, frame_chunk=2), params


def test_extractor_matches_jax_on_a_size_that_is_not_a_patch_multiple(tiny_jax_extractor):
    """preprocess (bilinear 45x33 -> 42x28, ImageNet normalisation) and the
    zero-padded 2-frame groups of a 3-frame video."""
    jax_ext, params = tiny_jax_extractor
    video = np.random.default_rng(7).integers(0, 256, (3, 45, 33, 3)).astype(np.uint8)
    ext = DinoFeatureExtractor(params=params, dtype=torch.float32, frame_chunk=2,
                               vit_config=ViTConfig(**TINY), device="cpu")
    np.testing.assert_allclose(ext.preprocess(video).numpy(),
                               np.asarray(jax_ext.preprocess(video)), rtol=0, atol=1e-5)
    got = ext(video)
    assert got.shape == (3, 3, 2, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ext(video)), **F32_TOL)


def test_extractor_refuses_to_fetch_weights(monkeypatch, caplog):
    """No params and no local HF cache: random weights from the seed, with a
    warning, and no download: without a cached snapshot ``from_pretrained``
    is not called at all (with a hub name it can send requests even under
    ``local_files_only``); a cached one loads from its local directory."""
    calls = []

    def fake_from_pretrained(name, **kwargs):
        calls.append((name, kwargs))
        raise OSError("not loadable")

    transformers = pytest.importorskip("transformers")
    huggingface_hub = pytest.importorskip("huggingface_hub")
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", fake_from_pretrained)
    monkeypatch.setattr(huggingface_hub, "try_to_load_from_cache", lambda name, file: None)
    a = DinoFeatureExtractor(vit_config=ViTConfig(**TINY), device="cpu", seed=3)
    assert calls == []
    monkeypatch.setattr(huggingface_hub, "try_to_load_from_cache",
                        lambda name, file: f"/hf-cache/snapshots/abc/{file}")
    b = DinoFeatureExtractor(vit_config=ViTConfig(**TINY), device="cpu", seed=3)
    assert calls == [("/hf-cache/snapshots/abc", {"local_files_only": True})]
    assert "RANDOM weights" in caplog.text
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert float(a.model.cls_token.detach().std()) > 0.5  # normal(1.0), as flax initialises it


def test_hf_converter_matches_jax():
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                          num_attention_heads=2, intermediate_size=128,
                                          patch_size=14, image_size=28)
    torch.manual_seed(0)
    state = transformers.Dinov2Model(hf_config).state_dict()
    want = jax_convert_hf(state, JaxViTConfig(**TINY))
    got = convert_hf_dinov2_params(state, ViTConfig(**TINY))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    # The converted tree loads into the port's encoder as it stands.
    _tiny_port(got)
