"""tdspa_torch.kernels.attention against the TPU kernels of
tdspa.kernels.attention (run in interpret mode) and the JAX attention core.

The CUDA kernel itself runs only on a GPU (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); on the CPU the wrapper runs its plain version,
``attention_reference``, which these tests hold to the Pallas bodies.

Tolerance: both sides take bf16 products with f32 accumulation and round the
probabilities to bf16 (the flash body before normalising, so a per-element
relative difference up to 2**-9 each side): |diff| <= 2e-2 for N(0, 1)
values; a bf16 output adds one bf16 ulp (rtol 2**-7).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.core.attention import masked_dot_product_attention
from tdspa.kernels.attention import _flash_attention, fused_masked_attention as jax_fused
from tdspa_torch.kernels import attention as ka
from tdspa_torch.kernels.attention import attention_reference, fused_masked_attention

ATOL = 2e-2


def _tol(out_dtype):
    return dict(atol=ATOL, rtol=2.0 ** -7 if out_dtype == "bf16" else 0.0)


def _dtypes(out_dtype):
    return {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]


def _inputs(seed, batch, seq, kv_len, heads, depth, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (
        rng.standard_normal((batch, n, heads, depth)).astype(np.float32)
        for n in (seq, kv_len, kv_len)
    )
    # Round to bf16 once, so both sides start from the same bf16 values.
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    mask = None
    if masked:
        mask = (rng.uniform(size=(batch, kv_len)) > 0.3).astype(np.float32)
        mask[0] = 0.0  # item 0 attends to nothing: the mean of its values
    return q, k, v, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [True, False])
def test_reference_matches_pallas_whole_kv_body(out_dtype, masked):
    """``_mha_kernel`` (whole KV per batch tile), D=96 as on the 3DSPA path."""
    q, k, v, mask = _inputs(0, 3, 9, 13, 2, 96, masked)
    jd, td = _dtypes(out_dtype)
    want = jax_fused(*map(lambda a: None if a is None else jnp.asarray(a), (q, k, v, mask)),
                     interpret=True, out_dtype=jd)
    got = attention_reference(*_torch(q, k, v, mask), out_dtype=td)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **_tol(out_dtype))


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [True, False])
def test_reference_matches_pallas_flash_body_ragged_k(out_dtype, masked):
    """``_mha_flash_kernel``: K=150 pads to a 512-key block; pad keys (mask -1)
    stay out even of the fully masked row's mean."""
    q, k, v, mask = _inputs(1, 2, 8, 150, 2, 96, masked)
    jd, td = _dtypes(out_dtype)
    want = _flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask),
                            interpret=True, out_dtype=jd)
    got = attention_reference(*_torch(q, k, v, mask), out_dtype=td)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **_tol(out_dtype))


def test_reference_matches_jax_attention_core():
    """The JAX core scales q in bf16 before the product, the kernels scale the
    f32 logits after: equal within the bf16 tolerance."""
    q, k, v, mask = _inputs(2, 4, 7, 11, 2, 96)
    want = masked_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask)[:, None, None, :], compute_dtype=jnp.bfloat16,
    )
    got = attention_reference(*_torch(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_row_is_the_mean_of_values():
    q, k, v, mask = _inputs(3, 2, 5, 151, 2, 96)
    got = attention_reference(*_torch(q, k, v, mask))
    want = np.broadcast_to(v[0].mean(axis=0), got[0].shape)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-2)


@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bool])
def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing(mask_dtype):
    q, k, v, mask = _torch(*_inputs(4, 2, 6, 9, 2, 96))
    before = fused_masked_attention.launches
    got = fused_masked_attention(q, k, v, mask.to(mask_dtype), out_dtype=torch.bfloat16)
    torch.testing.assert_close(got, attention_reference(q, k, v, mask, torch.bfloat16),
                               rtol=0, atol=0)
    assert fused_masked_attention.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = _torch(*_inputs(5, 2, 6, 9, 2, 96))
    with pytest.raises(ValueError, match="batch, heads or width"):
        fused_masked_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="key_mask"):
        fused_masked_attention(q, k, v, mask[:, :4])
    with pytest.raises(ValueError, match="out_dtype"):
        fused_masked_attention(q, k, v, out_dtype=torch.float16)


@pytest.mark.parametrize(
    "batch,seq,heads",
    [(2048, 151, 8), (1, 128, 8), (512, 129, 8), (2, 1297, 12), (1, 1, 1), (7, 16, 3)],
)
def test_launch_shape_covers_every_query_row(batch, seq, heads):
    q_blocks, warps = ka._launch_shape(batch, seq, heads, sms=132)
    assert 1 <= warps <= 8 and q_blocks >= 1
    assert q_blocks * warps * 16 >= seq
    assert (q_blocks - 1) * warps * 16 < seq  # no block without a row


def test_ctypes_signature_matches_the_cuda_entry_point():
    """The kernel loads only on a GPU host; its C signature is checked here."""
    src = (Path(ka.build.CSRC) / "attention.cu").read_text()
    decl = re.search(r'extern "C" int tdspa_attention_forward\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in decl.split(",")]
    kinds = [
        ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float") else ctypes.c_int
        for p in params
    ]
    assert kinds == ka.ARGTYPES
