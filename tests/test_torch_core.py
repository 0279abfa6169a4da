"""tdspa_torch.core against tdspa.core: embeddings, masks, the QK-norm
attention and the transformer stack, with parameters carried from flax.

Inputs are made from a seed with numpy and fed to both. f32 cases hold at
1e-5 (the two only sum in different orders); bf16 cases at a bf16 tolerance
(both round to bf16 after every projection, at slightly different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.core import attention as jattn
from tdspa.core.embeddings import ParamStateInit as JParamStateInit
from tdspa.core.embeddings import SinusoidalEmbedding
from tdspa.core.masks import readout_temporal_mask as j_readout_mask
from tdspa_torch.core import attention as tattn
from tdspa_torch.core.embeddings import ParamStateInit, sinusoidal_embedding
from tdspa_torch.core.masks import readout_temporal_mask
from tdspa_torch.infer.convert import params_from_flax

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _init(module, seed, *args, **kwargs):
    """flax params for ``module``, every leaf perturbed so scales and biases
    are not their trivial initial values."""
    params = module.init(jax.random.PRNGKey(seed), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params
    )


def _load(module, params):
    module.load_state_dict(params_from_flax(params))
    return module


@pytest.mark.parametrize("num_frequencies,shape", [(4, (2, 5, 3)), (32, (7, 4))])
def test_sinusoidal_embedding_matches_flax(num_frequencies, shape):
    x = np.random.default_rng(0).uniform(-2, 2, shape).astype(np.float32)
    want = SinusoidalEmbedding(num_frequencies).apply({}, jnp.asarray(x))
    got = sinusoidal_embedding(torch.from_numpy(x), num_frequencies)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_param_state_init_broadcasts_the_flax_parameter():
    jmod = JParamStateInit(shape=(3, 5))
    params = _init(jmod, 0, (2, 4))
    want = jmod.apply({"params": params}, (2, 4))
    tmod = _load(ParamStateInit((3, 5), torch.device("cpu")), params)
    np.testing.assert_array_equal(tmod((2, 4)).detach().numpy(), np.asarray(want))


def test_readout_temporal_mask_matches_jax():
    rng = np.random.default_rng(1)
    visible = (rng.uniform(size=(2, 5, 7, 1)) > 0.4).astype(np.float32)
    boundary = np.array([7, 4], np.int32)
    want = j_readout_mask(jnp.asarray(visible), jnp.asarray(boundary))
    got = readout_temporal_mask(torch.from_numpy(visible), torch.from_numpy(boundary))
    assert got.shape == (2, 5, 1, 8) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_masked_dot_product_attention_matches_jax(compute):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, n, 3, 8)).astype(np.float32) for n in (5, 6, 6))
    mask = (rng.uniform(size=(2, 1, 1, 6)) > 0.3).astype(np.float32)
    mask[0] = 0.0  # a fully masked item: the mean of the values
    jd, td = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jattn.masked_dot_product_attention(*map(jnp.asarray, (q, k, v, mask)), compute_dtype=jd)
    got = tattn.masked_dot_product_attention(
        *map(torch.from_numpy, (q, k, v, mask)), compute_dtype=td
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(F32_TOL if compute == "f32" else BF16_TOL))
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        got[0].numpy().mean(0, keepdims=True), got[0].shape), **F32_TOL)


def _qk_inputs(rng, kv_len=6, kv_width=12, masked=False):
    xq = rng.standard_normal((2, 5, 16)).astype(np.float32)
    xkv = rng.standard_normal((2, kv_len, kv_width)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=(2, 1, 1, kv_len)) > 0.3).astype(np.float32)
        mask[1] = 0.0
    return xq, xkv, mask


@pytest.mark.parametrize("case", ["self", "cross", "masked"])
def test_qknorm_attention_matches_flax(case):
    rng = np.random.default_rng(3)
    xq, xkv, mask = _qk_inputs(rng, kv_len=5 if case == "masked" else 6, kv_width=16,
                               masked=case == "masked")
    if case == "self":
        xkv = xq
    jmod = jattn.QKNormAttention(num_heads=2, qk_size=16)
    jargs = [jnp.asarray(xq), jnp.asarray(xkv), None if mask is None else jnp.asarray(mask)]
    params = _init(jmod, 3, *jargs)
    want = jmod.apply({"params": params}, *jargs)
    tmod = _load(tattn.QKNormAttention(16, xkv.shape[-1], num_heads=2, qk_size=16), params)
    got = tmod(torch.from_numpy(xq), torch.from_numpy(xkv),
               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


def test_layer_norm_eps_is_flax_default():
    """Inputs with a tiny variance, where eps = 1e-6 vs torch's 1e-5 shows."""
    x = (1e-3 * np.random.default_rng(4).standard_normal((3, 16))).astype(np.float32)
    from flax import linen as nn

    for jmod, tmod in [
        (nn.LayerNorm(use_bias=False), tattn.LayerNorm(16, torch.float32, "cpu")),
        (nn.RMSNorm(), tattn.RMSNorm(16, torch.float32, "cpu")),
    ]:
        params = _init(jmod, 4, jnp.asarray(x))
        want = jmod.apply({"params": params}, jnp.asarray(x))
        got = _load(tmod, params)(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cross", [False, True])
def test_parallel_transformer_block_matches_flax(cross):
    rng = np.random.default_rng(5)
    xq, xkv, _ = _qk_inputs(rng)
    qq_mask = (rng.uniform(size=(2, 1, 1, 5)) > 0.3).astype(np.float32)
    jmod = jattn.ParallelTransformerBlock(mlp_size=24, num_heads=2, qkv_size=16)
    jkv = jnp.asarray(xkv) if cross else None
    params = _init(jmod, 5, jnp.asarray(xq), jkv, qq_mask=jnp.asarray(qq_mask))
    want = jmod.apply({"params": params}, jnp.asarray(xq), jkv, qq_mask=jnp.asarray(qq_mask))
    tmod = _load(tattn.ParallelTransformerBlock(
        16, 24, 2, 16, kv_width=12 if cross else None), params)
    got = tmod(torch.from_numpy(xq), torch.from_numpy(xkv) if cross else None,
               qq_mask=torch.from_numpy(qq_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16_residual", "bf16_compute"])
def test_transformer_stack_matches_flax(precision):
    """Two layers, cross-attention, rank-matched masks (head axis inserted)."""
    rng = np.random.default_rng(6)
    xq, xkv, _ = _qk_inputs(rng)
    qq_mask = (rng.uniform(size=(2, 5, 5)) > 0.3).astype(np.float32)  # ndim == queries.ndim
    qk_mask = (rng.uniform(size=(2, 1, 6)) > 0.3).astype(np.float32)
    qq_mask[:, :, 0] = 1.0
    jd, td = {
        "f32": ((jnp.float32, jnp.float32), (torch.float32, torch.float32)),
        "bf16_residual": ((jnp.float32, jnp.bfloat16), (torch.float32, torch.bfloat16)),
        "bf16_compute": ((jnp.bfloat16, jnp.bfloat16), (torch.bfloat16, torch.bfloat16)),
    }[precision]
    jmod = jattn.TransformerStack(qkv_size=16, num_heads=2, mlp_size=24, num_layers=2,
                                  dtype=jd[0], residual_dtype=jd[1])
    jargs = dict(inputs_kv=jnp.asarray(xkv), qk_mask=jnp.asarray(qk_mask),
                 qq_mask=jnp.asarray(qq_mask))
    params = _init(jmod, 6, jnp.asarray(xq), **jargs)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(xq), **jargs).astype(jnp.float32))
    tmod = _load(tattn.TransformerStack(16, 16, 2, 24, 2, kv_width=12, dtype=td[0],
                                        residual_dtype=td[1]), params)
    got = tmod(torch.from_numpy(xq), inputs_kv=torch.from_numpy(xkv),
               qk_mask=torch.from_numpy(qk_mask), qq_mask=torch.from_numpy(qq_mask))
    assert got.dtype == td[1]
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.detach().float().numpy(), want, **tol)


def test_stack_parameter_names_match_flax():
    jmod = jattn.TransformerStack(qkv_size=16, num_heads=2, mlp_size=24, num_layers=2)
    x, kv = jnp.ones((1, 3, 16)), jnp.ones((1, 4, 12))
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, kv)["params"]
    flat = params_from_flax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), params))
    tmod = tattn.TransformerStack(16, 16, 2, 24, 2, kv_width=12)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in tmod.state_dict().items()
    }
