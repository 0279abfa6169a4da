"""tdspa_torch.models against tdspa.models: the tiny TrackAutoEncoder3D with
flax parameters carried over, its chunked paths, the bottleneck dither and
the bf16 path against the JAX model's interpret-mode Pallas attention.

f32 outputs hold at 2e-5 (summation order only). The bf16 case rounds to
bf16 after every projection and attends through the Pallas kernel on the JAX
side, the plain bf16 path on the CPU here: 5e-2 of the outputs' range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.kernels import attention as jax_kernels
from tdspa.models import TrackAutoEncoder3D as JTrackAutoEncoder3D
from tdspa.models import trajan2d as jtrajan
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.models import TrackAutoEncoder3D, trajan2d
from tdspa_torch.utils import jax_prng
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_3d, to_torch

T = 12
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _params(seed=1, use_dino=True, use_depth=True):
    """A perturbed flax-layout tree from the port's own seeded init (flax's
    init compiles for seconds; the tree's names and shapes are held to
    flax's in ``test_full_size_parameter_tree_matches_flax``)."""
    model = tiny_model_3d(T, device="cpu", seed=seed, use_dino=use_dino, use_depth=use_depth)
    rng = np.random.default_rng(seed)
    # Perturb every leaf: biases and norm scales start at trivial values.
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(model.state_dict()),
    )


def _pair(with_features=True, **overrides):
    batch = synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T,
                            with_features=with_features)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_tiny_model_3d(T, **overrides)
    params = _params(use_dino=overrides.get("use_dino", True),
                     use_depth=overrides.get("use_depth", True))
    tmodel = tiny_model_3d(T, device="cpu", **overrides)
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, jbatch, tmodel, to_torch(batch)


def _apply(jmodel, params, batch, **kwargs):
    return jax.jit(functools.partial(jmodel.apply, **kwargs))({"params": params}, batch)


def _assert_results(got, want, **tol):
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(
            getattr(got, name).detach().float().numpy(),
            np.asarray(getattr(want, name)).astype(np.float32), **tol, err_msg=name,
        )


@pytest.mark.parametrize("features", [True, False])
def test_tiny_model_matches_flax_f32(features):
    jmodel, params, jbatch, tmodel, tbatch = _pair(
        with_features=features, use_dino=features, use_depth=features
    )
    with torch.no_grad():
        _assert_results(tmodel(tbatch), _apply(jmodel, params, jbatch), **F32_TOL)
        latents = tmodel.encode(tbatch)
    want = _apply(jmodel, params, jbatch, method=jmodel.encode)
    np.testing.assert_allclose(latents.numpy(), np.asarray(want), **F32_TOL)


def test_default_query_grid_path_matches_flax():
    jmodel, params, jbatch, tmodel, tbatch = _pair()
    del jbatch["query_points"], tbatch["query_points"]
    with torch.no_grad():
        got = tmodel(tbatch)
    assert got.tracks.shape == (2, 32 * 32, T, 3)
    _assert_results(got, _apply(jmodel, params, jbatch), **F32_TOL)


def test_chunked_encode_and_decode_equal_unchunked():
    _, params, _, tmodel, tbatch = _pair()
    chunked = tiny_model_3d(T, device="cpu", encoder_scan_chunk_size=4, decoder_scan_chunk_size=2)
    chunked.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        _assert_results(chunked(tbatch), tmodel(tbatch), rtol=1e-6, atol=1e-6)


def test_chunked_model_matches_flax_chunked_model():
    chunks = dict(encoder_scan_chunk_size=2, decoder_scan_chunk_size=2)
    jmodel, params, jbatch, tmodel, tbatch = _pair(**chunks)
    with torch.no_grad():
        _assert_results(tmodel(tbatch), _apply(jmodel, params, jbatch), **F32_TOL)


@pytest.mark.parametrize("shape", [(1, 128, 96), (2, 128, 96), (2, 8, 8), (3, 5), (1000,)])
def test_dither_is_bit_exact_against_jax(shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    got = jax_prng.uniform(shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_latents_is_bit_exact_against_jax():
    x = np.random.default_rng(2).uniform(-1.5, 1.5, (2, 8, 8)).astype(np.float32)
    want = np.asarray(jtrajan.quantize_latents(jnp.asarray(x)))
    got = trajan2d.quantize_latents(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_append_time_feature_and_query_grid_match_jax():
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((2, 3, 4, 140)).astype(np.float32)
    frames = np.array([[0, 2, 4], [1, 3, 5]], np.int32)  # 5*t + 127 crosses 140 from t=3
    want = jtrajan.append_time_feature(jnp.asarray(latents), jnp.asarray(frames))
    got = trajan2d.append_time_feature(torch.from_numpy(latents), torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        trajan2d.default_query_grid((2,), num_coords=3).numpy(),
        np.asarray(jtrajan.default_query_grid((2,), num_coords=3)),
    )


def test_bf16_model_matches_flax_with_interpret_mode_kernel(monkeypatch):
    """JAX side: fused attention through the Pallas bodies in interpret mode."""
    monkeypatch.setattr(jax_kernels, "INTERPRET_DEFAULT", True)
    jmodel, params, jbatch, tmodel, tbatch = _pair(
        dtype=jnp.bfloat16, fused_attention=True
    )
    tbf16 = tiny_model_3d(T, device="cpu", dtype=torch.bfloat16, fused_attention=True)
    tbf16.load_state_dict(params_from_flax(params))
    want = _apply(jmodel, params, jbatch)
    with torch.no_grad():
        got = tbf16(tbatch)
    scale = float(np.abs(np.asarray(want.tracks)).max())
    _assert_results(got, want, rtol=0, atol=5e-2 * scale)


def test_full_size_parameter_tree_matches_flax():
    """Every name and shape of the default (full-size) model."""
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
        0, batch=1, num_support=2, num_queries=2, num_frames=150, with_features=True).items()}
    shapes = jax.eval_shape(JTrackAutoEncoder3D().init, jax.random.PRNGKey(0), batch)["params"]
    want = {k: tuple(v.shape) for k, v in params_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    model = TrackAutoEncoder3D(device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("knob", ["quantize", "fused_block"])
def test_unported_kernels_raise(knob):
    """Both serving knobs were unported until their kernels came (PR 4): they
    no longer raise and reach every block of the four stacks."""
    from tdspa_torch.core.attention import ParallelTransformerBlock
    from tdspa_torch.core.quant import QuantDenseGeneral

    model = tiny_model_3d(T, device="cpu", **{knob: True})
    blocks = [m for m in model.modules() if isinstance(m, ParallelTransformerBlock)]
    assert len(blocks) == 4 and all(getattr(b, knob) for b in blocks)
    quantised = [m for m in model.modules() if isinstance(m, QuantDenseGeneral)]
    assert len(quantised) == (4 * 6 + 4 if knob == "quantize" else 0)  # + the cross-attention


def test_gpu_entry_point_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiny_model_3d(T)
