"""The attention backward's plain version, ``attention_backward_reference``
(the CPU route of ``fused_attention_fn``'s backward and what the card holds
``csrc/attention_backward.cu`` to), against ``jax.vjp`` of JAX's
``_xla_reference``, the function whose VJP JAX's ``fused_attention``
recomputes.

Tolerance: both round at the same points (q / sqrt(D) in bf16, f32 products
and softmax, dP and each input's cotangent in bf16) and differ by f32
summation order, which can move a cotangent's bf16 rounding by one step: at
most 2**-7 relative, plus 1e-5 of each gradient's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.kernels.attention import _xla_reference
from tdspa_torch.kernels import attention as ka


def _inputs(seed, batch, seq, kv_len, heads, depth, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((batch, n, heads, depth)).astype(np.float32)
               for n in (seq, kv_len, kv_len))
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    g = rng.standard_normal((batch, seq, heads, depth)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(batch, kv_len)) > 0.3
        mask[0] = False  # item 0 attends to nothing
    return q, k, v, mask, g


def _jax_grads(q, k, v, mask, g):
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: _xla_reference(a, b, c, jm), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("depth", [64, 96])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("seq,kv_len", [(9, 150), (5, 300)])
def test_reference_matches_jax_vjp(depth, masked, seq, kv_len):
    """S != K, K over several of the kernel's 64-key tiles (150) and over two
    of its 160-key chunks (300); masked with a fully masked item, whose dq is
    exactly zero, or unmasked."""
    q, k, v, mask, g = _inputs(depth + kv_len, 2, seq, kv_len, 2, depth, masked)
    want = _jax_grads(q, k, v, mask, g)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    got = ka.attention_backward_reference(tq, tk, tv, tm, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_close(a, b, name)
    if masked:
        assert float(got[0][0].abs().max()) == 0.0


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True), (False, False, True)])
def test_reference_gives_only_the_gradients_asked_for(needs):
    q, k, v, mask, g = _inputs(3, 2, 6, 70, 2, 64, True)
    want = _jax_grads(q, k, v, mask, g)
    got = ka.attention_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, mask, g)),
                                          needs=needs)
    for name, a, b, n in zip(("dq", "dk", "dv"), got, want, needs):
        if not n:
            assert a is None
            continue
        assert a.dtype == torch.float32  # the inputs' dtype, rounded to bf16
        _assert_close(a, b, name)


def test_cpu_backward_runs_the_plain_version_and_launches_nothing():
    q, k, v, mask, g = _inputs(4, 2, 7, 19, 2, 96, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    before = ka.attention_backward.launches
    out = ka.fused_attention_fn(tq, tk, tv, torch.from_numpy(mask))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    want = ka.attention_backward_reference(tq.detach(), tk.detach(), tv.detach(),
                                           torch.from_numpy(mask), torch.from_numpy(g))
    assert ka.attention_backward.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seq,kv_len,depth,chunks", [
    (151, 151, 96, (1, 1)), (128, 2048, 96, (1, 11)), (192, 192, 64, (1, 1)),
    (192, 193, 96, (1, 2)), (300, 9, 8, (2, 1)), (151, 151, 128, (2, 2))])
def test_backward_chunks(seq, kv_len, depth, chunks):
    """A work item of the kernel takes at most 192 query rows and 192 keys
    (128 for D > 96)."""
    assert ka.backward_chunks(seq, kv_len, depth) == chunks


def test_backward_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="g must be"):
        ka.attention_backward(q, q, q, None, torch.zeros(1, 4, 2, 4))
