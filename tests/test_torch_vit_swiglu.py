"""The port's DINOv2 ViT-g/14 path (``tdspa_torch/features/vit.py`` with
``ffn="swiglu"``, ``features/dino.py``, the pipeline's DINO width) against
the plain reference ``tests/plain/dinov2.py`` on the CPU.

Weights are seeded under the published checkpoint's names and carried into
the port by ``convert_hf_dinov2_params`` and ``params_from_flax``, the path
a real checkpoint takes. Tolerance: f32 on both sides, the same products
summed in another order, on tokens of unit scale (LayerNorm output): 2e-5
abs, as in ``tests/test_torch_vit.py``. Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.profiler as tp

from tdspa_torch.features.depth import ConstantDepthProvider
from tdspa_torch.features.dino import DinoFeatureExtractor, dino_config
from tdspa_torch.features.tracks import StaticGridProvider
from tdspa_torch.features.vit import Dinov2, ViTConfig, convert_hf_dinov2_params
from tdspa_torch.infer import pipeline as pipeline_lib
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.infer.pipeline import InferencePipeline
from tdspa_torch.ops.resize import resize_torch_bicubic
from tdspa_torch.utils.testing import tiny_model_3d
from tests.plain import dinov2 as plain

F32_TOL = dict(rtol=2e-5, atol=2e-5)
TINY = dict(hidden_size=48, num_layers=2, num_heads=3, patch_size=14, image_size=28)
GIANT_PARAMS = 1_136_479_232


def hf_config(config: ViTConfig) -> dict:
    """The port's configuration under ``Dinov2Config``'s keys."""
    return {"hidden_size": config.hidden_size, "num_hidden_layers": config.num_layers,
            "num_attention_heads": config.num_heads, "mlp_ratio": config.mlp_ratio,
            "patch_size": config.patch_size, "image_size": config.image_size,
            "layer_norm_eps": config.layer_norm_eps,
            "use_swiglu_ffn": config.ffn == "swiglu"}


def hf_state(cfg: dict, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded weights under the checkpoint's names: normals of 1/sqrt(fan in)
    for matrices, scales near 1 for norms and layer scales, small biases, and
    the unused ``mask_token``."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, shape in plain.state_shapes(cfg).items():
        x = torch.randn(shape, generator=gen)
        if name.endswith(("norm1.weight", "norm2.weight", "layernorm.weight", "lambda1")):
            x = 1.0 + 0.1 * x
        elif len(shape) == 1:
            x = 0.1 * x
        elif name.endswith("weight"):
            x = x / np.sqrt(np.prod(shape[1:]))
        state[name] = x
    state["embeddings.mask_token"] = torch.zeros(1, cfg["hidden_size"])
    return state


def port_model(config: ViTConfig, state: dict, **kwargs) -> Dinov2:
    model = Dinov2(config, device="cpu", **kwargs)
    model.load_state_dict(params_from_flax(convert_hf_dinov2_params(state, config)))
    return model


@pytest.mark.parametrize("height,width", [(28, 28), (56, 70), (42, 42)],
                         ids=["native", "interpolated_4x5", "interpolated_3x3"])
def test_tiny_swiglu_vit_matches_plain_reference(height, width):
    """The native 2x2 patch grid, and 4x5 and 3x3 grids with the position
    table resized as HF resizes it."""
    config = ViTConfig(**TINY, ffn="swiglu", pos_resize="hf")
    state = hf_state(hf_config(config), seed=1)
    model = port_model(config, state)
    img = torch.randn((2, height, width, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model(img)
        want = plain.forward(state, img.permute(0, 3, 1, 2), hf_config(config))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("in_hw,out_hw", [((37, 37), (36, 36)), ((2, 2), (4, 5)),
                                           ((5, 7), (5, 3))])
def test_torch_bicubic_resize_is_f_interpolate(in_hw, out_hw):
    """The position table's HF resize as two contractions: F.interpolate's
    bicubic (a = -0.75, no antialiasing) within f32 rounding (2e-6 on unit
    values)."""
    x = torch.randn((2, *in_hw, 8), generator=torch.Generator().manual_seed(9))
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bicubic",
                                           align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(resize_torch_bicubic(x, out_hw).numpy(), want.numpy(),
                               rtol=0, atol=2e-6)


def test_plain_reference_is_hf_dinov2model():
    """The reference computes what transformers' ``Dinov2Model`` computes,
    SwiGLU and an interpolated position table included (f32, 2e-5)."""
    transformers = pytest.importorskip("transformers")
    config = ViTConfig(**TINY, ffn="swiglu")
    cfg = hf_config(config)
    hf = transformers.Dinov2Model(transformers.Dinov2Config(
        hidden_size=cfg["hidden_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"], mlp_ratio=cfg["mlp_ratio"],
        patch_size=cfg["patch_size"], image_size=cfg["image_size"], use_swiglu_ffn=True,
        layer_norm_eps=cfg["layer_norm_eps"])).eval()
    state = hf_state(cfg, seed=3)
    hf.load_state_dict(state)
    pixels = torch.randn((2, 3, 42, 56), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(pixel_values=pixels).last_hidden_state
        got = plain.forward(state, pixels, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_plain_reference_is_the_benchmark_reference(ffn):
    """The benchmark's frozen reference (``benchmark/reference/dinov2.py``,
    with its precision control and weight laws) computes what this one
    does, so a fix to either that the other lacks shows here (f32, 2e-5)."""
    from benchmark.reference.dinov2 import Backbone

    config = ViTConfig(**TINY, ffn=ffn, pos_resize="hf")
    cfg = hf_config(config)
    state = hf_state(cfg, seed=10)
    bench_cfg = {"hidden_size": config.hidden_size, "num_layers": config.num_layers,
                 "num_heads": config.num_heads, "mlp_ratio": config.mlp_ratio, "ffn": ffn,
                 "patch_size": config.patch_size, "image_size": config.image_size,
                 "layer_norm_eps": config.layer_norm_eps}
    pixels = torch.randn((2, 3, 56, 42), generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        want = plain.forward(state, pixels, cfg)
        got = Backbone(bench_cfg, state)(pixels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_converter_reads_every_tensor_of_the_giant_layout():
    """A state dict in the giant's key layout (its 40 layers and 24 heads,
    at a small width): every tensor but ``mask_token`` is read and lands
    where the port's model takes it; an ``fc1`` layout is refused."""
    small = ViTConfig(hidden_size=48, num_layers=40, num_heads=24, image_size=28, ffn="swiglu")
    giant = dino_config("facebook/dinov2-giant")
    assert plain.state_shapes(hf_config(small)).keys() == \
        plain.state_shapes(hf_config(giant)).keys()

    class Recording(dict):
        read = set()

        def __getitem__(self, key):
            self.read.add(key)
            return super().__getitem__(key)

    state = Recording(hf_state(hf_config(small), seed=5))
    model = port_model(small, state)
    assert Recording.read == set(state) - {"embeddings.mask_token"}
    got = model.state_dict()
    np.testing.assert_array_equal(got["layer_39.weights_in.kernel"].numpy(),
                                  state["encoder.layer.39.mlp.weights_in.weight"].T.numpy())
    np.testing.assert_array_equal(got["layer_0.weights_out.bias"].numpy(),
                                  state["encoder.layer.0.mlp.weights_out.bias"].numpy())
    mlp_state = hf_state(hf_config(ViTConfig(**TINY)), seed=6)
    with pytest.raises(KeyError, match="weights_in"):
        convert_hf_dinov2_params(mlp_state, ViTConfig(**TINY, ffn="swiglu"))


def test_giant_preset_has_the_published_size():
    config = ViTConfig.preset("vitg")
    assert (config.hidden_size, config.num_layers, config.num_heads, config.ffn) == \
        (1536, 40, 24, "swiglu")
    assert config.ffn_hidden_size == 4096 and ViTConfig.preset("vitb").ffn_hidden_size == 3072
    model = Dinov2(dino_config("facebook/dinov2-giant"), device="meta")
    assert sum(p.numel() for p in model.parameters()) == GIANT_PARAMS
    assert model.layer_0.weights_in.kernel.shape == (1536, 8192)
    assert not hasattr(model.layer_0, "fc1")


def test_unknown_names_and_kinds_are_refused():
    with pytest.raises(ValueError, match="unknown DINOv2 model"):
        DinoFeatureExtractor(model_name="facebook/dinov2-huge", device="cpu")
    with pytest.raises(ValueError, match="unknown DINOv2 model"):
        InferencePipeline(dino_model="facebook/dinov2-huge", device="cpu")
    with pytest.raises(ValueError, match="ffn"):
        ViTConfig(ffn="geglu")
    # A configuration given outright needs no known name.
    ext = DinoFeatureExtractor(model_name="local/tiny", vit_config=ViTConfig(**TINY),
                               params=convert_hf_dinov2_params(
                                   hf_state(hf_config(ViTConfig(**TINY))), ViTConfig(**TINY)),
                               device="cpu")
    assert ext.config.hidden_size == 48


T, H, W = 8, 28, 42


def tiny_extractor(seed: int = 7) -> DinoFeatureExtractor:
    config = ViTConfig(**TINY, ffn="swiglu", pos_resize="hf")
    params = convert_hf_dinov2_params(hf_state(hf_config(config), seed), config)
    return DinoFeatureExtractor(params=params, vit_config=config, dtype=torch.float32,
                                frame_chunk=4, device="cpu")


def test_pipeline_model_follows_the_backbone_width():
    """No model passed: its DINO projection is the backbone's width (the
    extractor's 48, the giant's 1536) and the tail runs on 48-d features."""
    assert InferencePipeline(dino_model="facebook/dinov2-giant", num_output_frames=T,
                             device="cpu").model.dino_projection.kernel.shape[0] == 1536
    pipe = InferencePipeline(dino_extractor=tiny_extractor(), num_output_frames=T,
                             num_support_tracks=8, num_query_points=4,
                             track_provider=StaticGridProvider(grid_size=4),
                             depth_provider=ConstantDepthProvider(), dtype=torch.float32,
                             device="cpu")
    assert pipe.model.dino_projection.kernel.shape[0] == 48
    video = np.random.default_rng(8).integers(0, 256, (T, H, W, 3)).astype(np.uint8)
    results = pipe.run_on_frames(video)
    assert results["dino_grid"].shape == (T, 2, 3, 48)
    assert results["predictions"].tracks.shape == (1, 4, T, 3)
    assert torch.isfinite(results["predictions"].tracks).all()


def test_pipeline_refuses_a_model_of_another_width(monkeypatch):
    """A passed model whose DINO projection is 768 wide: refused with a
    48-wide extractor passed in, and when a 48-wide one is built lazily."""
    model = tiny_model_3d(T, device="cpu")
    with pytest.raises(ValueError, match="768-d features.*48-d"):
        InferencePipeline(model=model, dino_extractor=tiny_extractor(), device="cpu")
    monkeypatch.setattr(pipeline_lib, "DinoFeatureExtractor",
                        lambda **kwargs: tiny_extractor())
    pipe = InferencePipeline(model=model, device="cpu")
    with pytest.raises(ValueError, match="768-d features.*48-d"):
        pipe.dino_extractor
    # Without DINO there is nothing to agree on.
    InferencePipeline(model=tiny_model_3d(T, device="cpu", use_dino=False), use_dino=False,
                      dino_extractor=tiny_extractor(), device="cpu")


def test_vit_spans_are_recorded_per_layer():
    """``tdspa.vit.embed`` once, ``attention`` and ``ffn`` once a block,
    ``final_norm`` once (``tests/test_torch_spans.py`` holds that a span
    records nothing while no profiler records)."""
    config = ViTConfig(**TINY, ffn="swiglu")
    model = port_model(config, hf_state(hf_config(config)))
    img = torch.randn((1, 28, 28, 3))
    with torch.no_grad(), tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        model(img)
    names = [e.name for e in prof.events() if e.name.startswith("tdspa.vit.")]
    assert sorted(names) == sorted(["tdspa.vit.embed", "tdspa.vit.final_norm"]
                                   + ["tdspa.vit.attention", "tdspa.vit.ffn"] * 2)
