"""tdspa_torch.kernels.attention against the TPU kernels of
tdspa.kernels.attention (run in interpret mode) and the JAX attention core.

The CUDA kernels themselves run only on a GPU (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); on the CPU both wrappers (``fused_masked_attention``
and the ViT's maskless ``vit_attention``) run their plain version,
``attention_reference``, which these tests hold to the Pallas bodies.

Tolerance: both sides take bf16 products with f32 accumulation and round the
probabilities to bf16 (the flash body before normalising, so a per-element
relative difference up to 2**-9 each side): |diff| <= 2e-2 for N(0, 1)
values; a bf16 output adds one bf16 ulp (rtol 2**-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from tdspa.core.attention import masked_dot_product_attention
from tdspa.kernels.attention import _flash_attention, _flash_perhead, _xla_reference
from tdspa.kernels.attention import fused_masked_attention as jax_fused
from tdspa_torch.kernels import attention as ka
from tdspa_torch.kernels.attention import (
    attention_reference,
    fused_attention_fn,
    fused_masked_attention,
    vit_attention,
    xla_reference,
)

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


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq,kv_len", [(21, 21), (9, 40)])
def test_reference_matches_pallas_perhead_body_ragged_k(out_dtype, seq, kv_len):
    """``_mha_flash_perhead_kernel`` (the ViT frames' maskless body, D=64):
    with 16-key blocks the last block is ragged and its tail is excluded by
    index from the static kv_len, as the ViT kernel does."""
    q, k, v, _ = _inputs(6, 2, seq, kv_len, 3, 64, masked=False)
    jd, td = _dtypes(out_dtype)
    want = _flash_perhead(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kb=16,
                          interpret=True, out_dtype=jd)
    got = attention_reference(*_torch(q, k, v), None, out_dtype=td)
    assert got.dtype == td
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


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_vit_cpu_dispatch_runs_the_plain_version_and_launches_nothing(out_dtype):
    q, k, v, _ = _torch(*_inputs(7, 2, 6, 9, 2, 64, masked=False))
    got = vit_attention(q, k, v, out_dtype=out_dtype)
    torch.testing.assert_close(got, attention_reference(q, k, v, None, out_dtype), rtol=0, atol=0)
    assert vit_attention.launches == fused_masked_attention.launches == 0
    with pytest.raises(ValueError, match="batch, heads or width"):
        vit_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="out_dtype"):
        vit_attention(q, k, v, out_dtype=torch.float16)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = _torch(*_inputs(5, 2, 6, 9, 2, 96))
    with pytest.raises(ValueError, match="batch, heads or width"):
        fused_masked_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="key_mask"):
        fused_masked_attention(q, k, v, mask[:, :4])
    with pytest.raises(ValueError, match="out_dtype"):
        fused_masked_attention(q, k, v, out_dtype=torch.float16)


@pytest.mark.parametrize(
    "batch,seq,kv_len,heads",
    [(2048, 151, 151, 8), (1, 128, 128, 8), (512, 129, 129, 8), (2, 1297, 1297, 12), (1, 1, 1, 1),
     (7, 16, 16, 3), (1, 128, 2048, 8)],
)
def test_launch_shape_covers_every_query_row(batch, seq, kv_len, heads):
    """``work_plan`` (the successor of the mma.sync kernel's launch shape):
    the row tiles cover S with no empty tile, the chunks cover the key tiles
    with no empty chunk, and the persistent grid has no idle block."""
    plan = ka.work_plan(batch, seq, kv_len, heads, sms=132)
    tiles = -(-kv_len // ka.KEY_TILE)
    assert plan["row_tiles"] * ka.QUERY_ROWS >= seq > (plan["row_tiles"] - 1) * ka.QUERY_ROWS
    assert plan["chunks"] * plan["chunk_tiles"] >= tiles > (plan["chunks"] - 1) * plan["chunk_tiles"]
    assert plan["work"] == batch * heads * plan["row_tiles"] * plan["chunks"]
    assert 1 <= plan["grid"] == min(plan["work"], 132)
    assert plan["cuda_kernels"] == (1 if plan["chunks"] == 1 else 2)


# The five main-path shapes and four edge shapes of chip_smoke.py (B, S, K, H).
PLAN_SHAPES = [(2048, 151, 151, 8), (1, 128, 128, 8), (1, 128, 2048, 8), (1, 128, 128, 8),
               (512, 129, 129, 8), (4, 151, 151, 8), (3, 77, 1000, 8), (2, 1297, 1297, 12),
               (1, 151, 151, 8)]


def _work_item(w, heads, plan, seq, kv_len):
    """Work item ``w`` as ``csrc/attention.cu``'s ``decode`` reads it (chunk
    fastest): (b, h, query rows [r0, r1), keys [k0, k1)) clipped to S and K."""
    chunks, row_tiles = plan["chunks"], plan["row_tiles"]
    chunk_keys = plan["chunk_tiles"] * ka.KEY_TILE
    c, r = w % chunks, w // chunks
    rt, r = r % row_tiles, r // row_tiles
    h, b = r % heads, r // heads
    return (b, h, rt * ka.QUERY_ROWS, min(seq, (rt + 1) * ka.QUERY_ROWS), c * chunk_keys,
            min(kv_len, (c + 1) * chunk_keys))


@pytest.mark.parametrize("batch,seq,kv_len,heads", PLAN_SHAPES)
def test_work_items_cover_every_row_and_key_once(batch, seq, kv_len, heads):
    """Every (item, head, query row, key) lies in exactly one work item, as the
    kernel decodes them; the B = 1 cross-attention over 2048 keys is split so
    that its items fill the SMs."""
    plan = ka.work_plan(batch, seq, kv_len, heads, sms=132)
    items = np.array([_work_item(w, heads, plan, seq, kv_len) for w in range(plan["work"])])
    b, h, r0, r1, k0, k1 = items.T
    assert (r0 < r1).all() and (k0 < k1).all() and (r1 <= seq).all() and (k1 <= kv_len).all()
    # Distinct rectangles whose areas sum to S x K per (item, head): a partition.
    assert len({tuple(row) for row in items}) == len(items)
    area = np.zeros((batch, heads), np.int64)
    np.add.at(area, (b, h), (r1 - r0) * (k1 - k0))
    assert (area == seq * kv_len).all()
    rows = {(int(x), int(y)) for x, y in zip(r0, r1)}
    keys = {(int(x), int(y)) for x, y in zip(k0, k1)}
    assert sum(y - x for x, y in rows) == seq and sum(y - x for x, y in keys) == kv_len
    if (batch, kv_len) == (1, 2048):
        assert plan["chunks"] > 1 and plan["work"] <= 132


def _kernel_model(q, k, v, mask, chunk_tiles, tile=64):
    """The kernel's arithmetic in plain PyTorch: per key chunk of
    ``chunk_tiles`` 64-key tiles an f32 online softmax on logits in log2
    units (the product times scale log2(e); masked logits finfo(f32).min, the
    running max starting there; P = 2^(x - max) rounded to bf16 before P.V),
    then the chunks merged as O = sum 2^(m_c - M) O_c / sum 2^(m_c - M) l_c."""
    fill = torch.finfo(torch.float32).min
    q, k, v = (torch.as_tensor(x).float() for x in (q, k, v))
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    attend = (torch.ones((batch, kv_len), dtype=torch.bool) if mask is None
              else torch.as_tensor(mask) != 0)
    parts = []
    for c0 in range(0, kv_len, chunk_tiles * tile):
        m = torch.full((batch, heads, seq), fill)
        l = torch.zeros((batch, heads, seq))
        o = torch.zeros((batch, heads, seq, depth))
        for t0 in range(c0, min(kv_len, c0 + chunk_tiles * tile), tile):
            t1 = min(kv_len, t0 + tile)  # keys past K are left out by index
            s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, t0:t1]) * np.float32(
                np.float32(1.0 / np.sqrt(depth)) * np.float32(np.log2(np.e)))
            s = s.masked_fill(~attend[:, None, None, t0:t1], fill)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), v[:, t0:t1])
            m = mx
        parts.append((o, m, l))
    big_m = torch.stack([m for _, m, _ in parts]).amax(0)
    weights = [torch.exp2(m - big_m) for _, m, _ in parts]
    num = sum(w[..., None] * o for w, (o, _, _) in zip(weights, parts))
    den = sum(w * l for w, (_, _, l) in zip(weights, parts))
    return (num / den[..., None]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("kv_len,chunk_tiles,masked", [
    (2048, 2, True), (2048, 2, False), (2048, 32, True), (1000, 3, True), (151, 3, True),
])
def test_split_merge_model_matches_the_reference(kv_len, chunk_tiles, masked):
    """K = 2048 split into 16 chunks (or kept whole), K = 1000 with a ragged
    last chunk and tile, and one chunk of 151 keys: the kernel's arithmetic
    equals ``attention_reference``; item 0 (every key masked) is the mean of
    its values in every chunking."""
    q, k, v, mask = _inputs(8, 2, 5, kv_len, 2, 32, masked)
    got = _kernel_model(q, k, v, mask, chunk_tiles)
    want = attention_reference(*_torch(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    if masked:
        np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(axis=0), got[0].shape),
                                   atol=1e-2)


@pytest.mark.parametrize("chunk_tiles", [3, 16])
def test_split_merge_model_matches_pallas_flash_body(chunk_tiles):
    """The kernel's chunked arithmetic against ``_mha_flash_kernel`` in
    interpret mode at K = 1000 (ragged: 16 tiles of 64, the last of 40)."""
    q, k, v, mask = _inputs(9, 2, 6, 1000, 2, 32)
    want = _flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                            interpret=True, out_dtype=jnp.float32)
    got = _kernel_model(q, k, v, mask, chunk_tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("depth", [64, 96])
@pytest.mark.parametrize("masked", [True, False])
def test_fused_attention_fn_gradients_match_jax_vjp(depth, masked):
    """``fused_attention_fn``'s dq, dk, dv (``attention_backward_reference``
    on the saved bf16 inputs) against ``jax.vjp`` of JAX's ``_xla_reference``
    at both head widths, masked (item 0 with every key masked) or not. Both
    round at the same points (q/sqrt(D) in bf16, f32 products and softmax,
    P in bf16, each input's cotangent in bf16), so they differ by f32
    summation order, which can move a cotangent's final bf16 rounding by one
    step (at most 2^-7 relative), plus 1e-5 of each gradient's largest
    value. The forward runs
    the kernel's plain version here; the recompute's output is held to
    ``_xla_reference`` at 1e-6."""
    q, k, v, mask = _inputs(10 + depth, 3, 7, 19, 2, depth, masked)
    g = np.random.default_rng(depth).standard_normal(q.shape).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    want_out, vjp = jax.vjp(lambda a, b, c: _xla_reference(a, b, c, jm),
                            *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = fused_attention_fn(*(x.to(torch.bfloat16) for x in (tq, tk, tv)), tm)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.detach(), attention_reference(tq, tk, tv, tm), rtol=0, atol=0)
    out.backward(torch.from_numpy(g))
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2.0 ** -7,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    np.testing.assert_allclose(xla_reference(*_torch(q, k, v, mask)).numpy(),
                               np.asarray(want_out), rtol=0, atol=1e-6)
    if masked:  # the fully masked item: uniform weights, so dq is zero
        assert float(tq.grad[0].abs().max()) == 0.0


def test_fused_attention_fn_gives_only_the_gradients_asked_for():
    q, k, v, mask = _torch(*_inputs(11, 2, 5, 9, 2, 64))
    k.requires_grad_()
    out = fused_attention_fn(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
                             mask)
    (dk,) = torch.autograd.grad(out.sum(), (k,))
    assert dk.shape == k.shape and q.grad is None
    assert fused_masked_attention.launches == 0  # CPU tensors: the plain version

