"""tdspa_torch's dynamic-int8 path against tdspa's: the quantiser, the
kernel's plain version against the Pallas kernel in interpret mode, the
quantised layers against the flax ones, and the tiny ``quantize=True``
model against the JAX model.

Tolerances: the quantised values agree exactly (the same f32 arithmetic:
XLA's product with f32(1/127) for the scale, a true division for x / scale,
round half to even), and the integer sums are exact on both sides, so only
the f32 dequantisation differs, by XLA's fusion of the two scale products
(~1e-7 relative): 1e-5, as JAX's own kernel test. The tiny f32 model: 2e-5
(f32 summation order in the unquantised layers; no activation lands on
another int8 step at this seed).
"""

from pathlib import Path
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.core import quant as jquant
from tdspa.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.core import quant
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.kernels import quant_matmul as kq
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_3d, to_torch

TOL = dict(rtol=1e-5, atol=1e-5)
T = 12


def _operands(m, k, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(lead + (m, k))).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 48, 40), (111, 32, 24)])
def test_reference_matches_pallas_kernel(x_dtype, shape):
    """The plain version follows the TPU kernel: x upcast to f32 in-kernel."""
    x, w = _operands(*shape)
    jx = jnp.asarray(x) if x_dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_quant_matmul(jx, jnp.asarray(w), interpret=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)  # exact: the values are bf16 already
    got = kq.quant_matmul_reference(tx, torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_takes_leading_dims_and_ragged_rows():
    x, w = _operands(37, 32, 16, seed=1, lead=(2, 3))  # M = 222 rows in all
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = kq.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 3, 37, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dynamic_int8_is_bit_exact_against_jitted_jax():
    x = (3.0 * np.random.default_rng(2).standard_normal((512, 48))).astype(np.float32)
    for axis in (-1, 0):
        q, s = jax.jit(lambda v, a=axis: jquant._dynamic_int8(v, axis=a))(jnp.asarray(x))
        tq, ts = quant.dynamic_int8(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


def test_int8_matmul_matches_jax_xla_path_f32():
    """``int8_matmul`` on CPU tensors vs JAX's XLA path (not the kernel)."""
    x, w = _operands(96, 64, 48, seed=3)
    want = np.asarray(jax.jit(jquant.int8_matmul)(jnp.asarray(x), jnp.asarray(w)))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    x, w = _operands(20, 32, 24)
    before = kq.quant_matmul.launches
    got = kq.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert kq.quant_matmul.launches == before
    want = kq.quant_matmul_reference(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"x \[..., K\]"):
        kq.quant_matmul(torch.from_numpy(x), torch.from_numpy(w).t())


def test_quantize_weight_is_the_transposed_per_column_quantiser():
    _, w = _operands(1, 48, 40, seed=4)
    wq, ws = kq.quantize_weight(torch.from_numpy(w))
    q, s = jax.jit(lambda v: jquant._dynamic_int8(v, axis=0))(jnp.asarray(w))
    assert wq.shape == (40, 48) and wq.is_contiguous() and ws.shape == (40,)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(q).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(s)[0])


@pytest.mark.parametrize("m,n,want", [
    (309248, 768, (128, 14496, 132)),  # input_qkv: every SM busy with 128-wide tiles
    (309248, 384, (128, 7248, 132)),  # input_out / input_mlp_out
    (66048, 1536, (128, 6192, 132)),  # readout_mlp_in
    (1111, 2048, (128, 144, 132)),  # the ragged M: 9 row tiles x 16 still fill the card
    (2048, 768, (64, 192, 132)),  # latents_cross_kv: 96 tiles at 128 wide, so 64
    (128, 512, (64, 8, 8)),  # latents_out: one row tile, launch-bound
    (3, 8, (64, 1, 1)),  # N = 8: one tile, masked
])
def test_launch_shape_picks_bn_and_covers_every_tile(m, n, want):
    bn, tiles, grid = kq._launch_shape(m, n, sms=132)
    assert (bn, tiles, grid) == want and bn in kq.BN_CHOICES
    m_tiles = -(-m // kq.ROWS)
    assert tiles == m_tiles * -(-n // bn) and tiles * kq.ROWS * bn >= m * n
    assert 1 <= grid <= min(tiles, 132)  # the persistent grid: no block without a tile


def test_cached_quantized_weight_follows_the_tensor():
    """The cache returns ``quantize_weight``'s integers, quantises anew after
    an in-place update, and never lends one tensor's entry to another."""
    _, w = _operands(1, 48, 40, seed=6)
    w = torch.from_numpy(w)
    first = kq.cached_quantized_weight(w)
    assert all(torch.equal(a, b) for a, b in zip(first, kq.quantize_weight(w)))
    assert kq.cached_quantized_weight(w)[0] is first[0]  # served from the cache
    with torch.no_grad():
        w.add_(0.5 * torch.linspace(-1.0, 1.0, 40))
    updated = kq.cached_quantized_weight(w)
    want = kq.quantize_weight(w)
    assert all(torch.equal(a, b) for a, b in zip(updated, want))
    assert not torch.equal(updated[1], first[1])
    other = w.clone()
    with torch.no_grad():
        other.mul_(2.0)
    doubled = kq.cached_quantized_weight(other)
    assert torch.equal(doubled[0], updated[0]) and torch.equal(doubled[1], 2 * updated[1])
    assert doubled[1] is not updated[1]
    view = w.reshape(40, 48)  # another shape of the same storage: its own entry
    assert kq.cached_quantized_weight(view)[0].shape == (48, 40)
    assert kq.cached_quantized_weight(w)[0] is updated[0]


@pytest.mark.parametrize("features,axis", [(8, -1), ((2, 8), -1), (16, (-2, -1))])
def test_quant_dense_layers_match_flax(features, axis):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 2, 8) if axis == (-2, -1) else (4, 16)).astype(np.float32)
    jmod = jquant.QuantDenseGeneral(features=features, axis=axis, use_bias=True) \
        if axis == (-2, -1) or isinstance(features, tuple) else jquant.QuantDense(features)
    params = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
    )
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    in_shape = x.shape[1:] if axis == (-2, -1) else x.shape[-1:]
    out_shape = (features,) if isinstance(features, int) else features
    tmod = quant.QuantDenseGeneral(in_shape, out_shape, True, "cpu")
    tmod.load_state_dict(params_from_flax(params))
    assert tmod.state_dict().keys() == {"kernel", "bias"}
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The same parameter tree as flax's plain Dense layers.
    plain = (fnn.DenseGeneral(features=features, axis=axis) if axis == (-2, -1)
             else fnn.DenseGeneral(features=features))
    plain_shapes = jax.tree_util.tree_map(
        np.shape, plain.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert jax.tree_util.tree_map(np.shape, params) == plain_shapes


def _tiny_params(seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(tiny_model_3d(T, device="cpu", seed=seed).state_dict()),
    )


def test_tiny_quantized_model_matches_jax_f32():
    batch = synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T,
                            with_features=True)
    params = _tiny_params()
    want = jax.jit(jax_tiny_model_3d(T, quantize=True).apply)(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = tiny_model_3d(T, device="cpu", quantize=True)
    model.load_state_dict(params_from_flax(params))
    plain = tiny_model_3d(T, device="cpu")
    assert model.state_dict().keys() == plain.state_dict().keys()  # one checkpoint for both
    with torch.no_grad():
        got = model(to_torch(batch))
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_the_table_binds_the_two_entry_points_of_the_source():
    src = (Path(kq.build.CSRC) / "quant_matmul.cu").read_text()
    table = {symbol for symbol, (library, _) in kq.build.ENTRIES.items()
             if library == "quant_matmul"}
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == table
    assert table == {"tdspa_quantize_rows", "tdspa_int8_gemm"}
