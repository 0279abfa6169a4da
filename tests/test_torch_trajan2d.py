"""tdspa_torch.models.TrackAutoEncoder (the 2D TRAJAN) and the 2D masks
against tdspa: the tiny model with flax parameters carried over, plain and
with encoder and decoder chunks, the default query grid, the parameter tree
of the default widths, and the bf16 model through JAX's interpret-mode
Pallas attention.

f32 outputs hold at 2e-5 (summation order only); the bf16 case at 5e-2 of
the outputs' range, as ``tests/test_torch_model.py`` holds the 3D model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.core import masks as jmasks
from tdspa.kernels import attention as jax_kernels
from tdspa.models import TrackAutoEncoder as JTrackAutoEncoder
from tdspa.utils.testing import tiny_model_2d as jax_tiny_model_2d
from tdspa_torch.core import masks
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.models import TrackAutoEncoder
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_2d, to_torch

T = 12
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _params(seed=1):
    """A perturbed flax-layout tree from the port's seeded init (its names
    and shapes are held to flax's in ``test_full_size_parameter_tree_matches_flax``)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(tiny_model_2d(T, device="cpu", seed=seed).state_dict()),
    )


def _pair(**overrides):
    batch = synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T, num_coords=2)
    params = _params()
    tmodel = tiny_model_2d(T, device="cpu", **overrides)
    tmodel.load_state_dict(params_from_flax(params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax_tiny_model_2d(T, **overrides), params, jbatch, tmodel, to_torch(batch)


def _apply(jmodel, params, batch, **kwargs):
    return jax.jit(functools.partial(jmodel.apply, **kwargs))({"params": params}, batch)


def _assert_results(got, want, **tol):
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(
            getattr(got, name).detach().float().numpy(),
            np.asarray(getattr(want, name)).astype(np.float32), **tol, err_msg=name,
        )


@pytest.mark.parametrize("chunks", [{}, dict(encoder_scan_chunk_size=4, decoder_scan_chunk_size=2)])
def test_tiny_model_matches_flax_f32(chunks):
    jmodel, params, jbatch, tmodel, tbatch = _pair(**chunks)
    with torch.no_grad():
        got = tmodel(tbatch)
        latents = tmodel.encode(tbatch)
    assert got.tracks.shape == (2, 4, T, 2)
    _assert_results(got, _apply(jmodel, params, jbatch), **F32_TOL)
    np.testing.assert_allclose(latents.numpy(),
                               np.asarray(_apply(jmodel, params, jbatch, method=jmodel.encode)),
                               **F32_TOL)


def test_default_query_grid_path_matches_flax():
    jmodel, params, jbatch, tmodel, tbatch = _pair()
    del jbatch["query_points"], tbatch["query_points"]
    with torch.no_grad():
        got = tmodel(tbatch)
    assert got.tracks.shape == (2, 32 * 32, T, 2)
    _assert_results(got, _apply(jmodel, params, jbatch), **F32_TOL)


def test_gradients_match_flax_through_the_remats():
    """The chunked model recomputes its encoder chunks and decoder calls in
    the backward pass (torch.utils.checkpoint, JAX's nn.remat): the
    gradient of a sum of its outputs equals flax's."""
    chunks = dict(encoder_scan_chunk_size=4, decoder_scan_chunk_size=2)
    jmodel, params, jbatch, tmodel, tbatch = _pair(**chunks)

    def objective(p):
        out = jmodel.apply({"params": p}, jbatch)
        return jnp.sum(out.tracks) + jnp.sum(out.visible_logits * out.certain_logits)

    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(objective))(params)))
    out = tmodel(tbatch)
    (out.tracks.sum() + (out.visible_logits * out.certain_logits).sum()).backward()
    for name, param in tmodel.named_parameters():
        scale = float(want[name].abs().max()) + 1e-6
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_bf16_model_matches_flax_with_interpret_mode_kernel(monkeypatch):
    """JAX side: fused attention through the Pallas bodies in interpret mode."""
    monkeypatch.setattr(jax_kernels, "INTERPRET_DEFAULT", True)
    jmodel, params, jbatch, _, tbatch = _pair(dtype=jnp.bfloat16, fused_attention=True)
    tbf16 = tiny_model_2d(T, device="cpu", dtype=torch.bfloat16, fused_attention=True)
    tbf16.load_state_dict(params_from_flax(params))
    want = _apply(jmodel, params, jbatch)
    with torch.no_grad():
        got = tbf16(tbatch)
    scale = float(np.abs(np.asarray(want.tracks)).max())
    _assert_results(got, want, rtol=0, atol=5e-2 * scale)


def test_full_size_parameter_tree_matches_flax():
    """Every name and shape of the default model: 68,333,080 parameters and
    no ``input_readout_token`` (flax creates no parameters for a submodule
    that is never called)."""
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
        0, batch=1, num_support=2, num_queries=2, num_frames=150, num_coords=2).items()}
    shapes = jax.eval_shape(JTrackAutoEncoder().init, jax.random.PRNGKey(0), batch)["params"]
    want = {k: tuple(v.shape) for k, v in params_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    model = TrackAutoEncoder(device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert sum(p.numel() for p in model.parameters()) == 68_333_080
    assert not any("input_readout_token" in k for k in want)


@pytest.mark.parametrize("boundary", [3, 12])
def test_masks_match_jax(boundary):
    rng = np.random.default_rng(boundary)
    visible = (rng.uniform(size=(2, 5, T, 1)) > 0.3).astype(np.float32)
    visible[0, 0] = 0.0  # a track invisible in every frame: a fully masked row
    bounds = np.array([boundary, T], np.int32)
    np.testing.assert_array_equal(
        masks.track_temporal_mask(torch.from_numpy(visible), torch.from_numpy(bounds)).numpy(),
        np.asarray(jmasks.track_temporal_mask(jnp.asarray(visible), jnp.asarray(bounds))))
    np.testing.assert_array_equal(
        masks.visibility_key_mask(torch.from_numpy(visible)).numpy(),
        np.asarray(jmasks.visibility_key_mask(jnp.asarray(visible))))


def test_gpu_entry_point_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiny_model_2d(T)
