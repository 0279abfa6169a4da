"""tdspa_torch's fused transformer block against tdspa's: the kernel's plain
version against the Pallas kernel in interpret mode, the operand layout,
the ``fused_block=True`` stack and tiny model against JAX's (with JAX's
kernels forced to interpret mode, as ``tests/unit/test_block_kernel.py``
does), and the gate that keeps masked, cross-attention and quantised calls
on the plain path.

Tolerances: the plain version rounds to bf16 at the points the TPU body
does, so it differs from the interpret kernel only by f32 summation order
(~1e-6 here, no bf16 rounding lands elsewhere at these seeds): 1e-4 abs. The
f32 stack and model: 2e-5, as the port's other f32 parity tests (the block
is the same kernel function on both sides). The bf16 model: 5e-2 of the
output range, as ``tests/test_torch_model.py``'s bf16 case (bf16 projections
outside the blocks round differently in the two frameworks).
"""

from pathlib import Path
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.core import attention as jattn
from tdspa.kernels import attention as jax_kernels
from tdspa.kernels.block import _flatten_params, fused_transformer_block as jax_block
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.core import attention as tattn
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.kernels import block as kb
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_3d, to_torch

N, S, C, H, QKV, MLP = 3, 9, 64, 2, 64, 96  # head width 32, which the kernel takes
KERNEL_TOL = dict(rtol=0, atol=1e-4)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
T = 12


def _perturbed(state_dict, seed, scale=0.1):
    """A flax tree from a port module's init with every leaf perturbed (norm
    scales and biases start at trivial values)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + scale * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(state_dict),
    )


def _block_tree(seed=0):
    block = tattn.ParallelTransformerBlock(C, MLP, H, QKV, device="cpu")
    tattn.reset_parameters(block, torch.Generator().manual_seed(seed))
    return _perturbed(block.state_dict(), seed + 1)


def _x(seed=2, shape=(N, S, C)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_block_reference_matches_pallas_kernel(out_dtype):
    tree, x = _block_tree(), _x()
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "f32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = np.asarray(jax_block(jnp.asarray(x), tree, H, interpret=True, out_dtype=jdt)
                      .astype(jnp.float32))
    got = kb.fused_transformer_block(torch.from_numpy(x), params_from_flax(tree), H,
                                     out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (N, S, C)
    np.testing.assert_allclose(got.float().numpy(), want, **KERNEL_TOL)


def test_block_reference_takes_leading_dims_and_bf16_input():
    tree = params_from_flax(_block_tree())
    x = torch.from_numpy(_x(3, (2, 3, S, C)))
    flat = kb.fused_transformer_block(x.reshape(6, S, C), tree, H)
    assert torch.equal(kb.fused_transformer_block(x, tree, H).reshape(6, S, C), flat)
    # x is rounded to bf16 at entry: a bf16 input gives the same result.
    assert torch.equal(kb.fused_transformer_block(x.to(torch.bfloat16), tree, H),
                       kb.fused_transformer_block(x.to(torch.bfloat16).float(), tree, H))


def test_flattened_operands_are_the_tpu_layout_transposed():
    tree = _block_tree()
    ops = kb.flatten_block_params(params_from_flax(tree))
    want = [np.asarray(o.astype(jnp.float32)) for o in _flatten_params(tree)]
    g1, wq, sq, wk, sk, wv, wo, bo, g2, w1, b1, w2, b2 = want
    hd = H * (QKV // H)
    head_major = [w.transpose(1, 0, 2).reshape(C, hd).T for w in (wq, wk, wv)]  # [H C Dh] ->
    np.testing.assert_array_equal(ops["wqkv_t"].float().numpy(), np.concatenate(head_major))
    np.testing.assert_array_equal(ops["wo_t"].float().numpy(), wo.reshape(hd, C).T)
    np.testing.assert_array_equal(ops["w1_t"].float().numpy(), w1.T)
    np.testing.assert_array_equal(ops["w2_t"].float().numpy(), w2.T)
    for name, row in (("g1", g1), ("sq", sq), ("sk", sk), ("bo", bo), ("g2", g2), ("b1", b1),
                      ("b2", b2)):
        np.testing.assert_array_equal(ops[name].float().numpy(), row[0], err_msg=name)
    assert all(o.dtype == torch.bfloat16 and o.is_contiguous() for o in ops.values())


def test_fused_stack_matches_jax_and_masked_and_cross_calls_stay_plain(monkeypatch):
    """JAX with its kernels in interpret mode; f32 compute on both sides."""
    monkeypatch.setattr(jax_kernels, "INTERPRET_DEFAULT", True)
    x, kv = _x(4, (4, S, C)), _x(5, (4, 7, 16))
    mask = (np.random.default_rng(6).uniform(size=(4, S, S)) > 0.3).astype(np.float32)
    mask[..., 0] = 1.0

    def port(fused, kv_width=None):
        stack = tattn.TransformerStack(C, QKV, H, MLP, 2, kv_width=kv_width, fused_block=fused,
                                       device="cpu")
        tattn.reset_parameters(stack, torch.Generator().manual_seed(8))
        return stack

    stack = port(True)
    tree = _perturbed(stack.state_dict(), 7)
    stack.load_state_dict(params_from_flax(tree))
    jstack = jattn.TransformerStack(qkv_size=QKV, num_heads=H, mlp_size=MLP, num_layers=2,
                                    fused_block=True)
    want = np.asarray(jax.jit(jstack.apply)({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = stack(torch.from_numpy(x))
        plain = port(False)
        plain.load_state_dict(stack.state_dict())
        unfused = plain(torch.from_numpy(x))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        assert not torch.equal(got, unfused)  # the kernel's function ran
        # Masked self-attention: the plain path, exactly.
        tmask = torch.from_numpy(mask)
        assert torch.equal(stack(torch.from_numpy(x), qq_mask=tmask),
                           plain(torch.from_numpy(x), qq_mask=tmask))
        # Cross-attention: the plain path, exactly.
        cross, cross_plain = port(True, 16), port(False, 16)
        cross_plain.load_state_dict(cross.state_dict())
        args = (torch.from_numpy(x), torch.from_numpy(kv))
        assert torch.equal(cross(*args), cross_plain(*args))


def test_gate_follows_the_kernel_limits_and_never_runs_under_quantize():
    x = torch.from_numpy(_x())
    for kwargs, applies in (({}, True), ({"quantize": True}, False)):
        block = tattn.ParallelTransformerBlock(C, MLP, H, QKV, fused_block=True, device="cpu",
                                               **kwargs)
        assert tattn._fused_block_applicable(block, x, None, None, None) is applies
    block = tattn.ParallelTransformerBlock(C, MLP, H, QKV, fused_block=True, device="cpu")
    assert not tattn._fused_block_applicable(block, x, x, None, None)
    assert not tattn._fused_block_applicable(block, x, None, torch.ones(1, 1, 1, S), None)
    assert not tattn._fused_block_applicable(block, torch.zeros(2, kb.MAX_SEQ + 1, C), None,
                                             None, None)
    narrow = tattn.ParallelTransformerBlock(C, MLP, H, 16, fused_block=True, device="cpu")
    assert not tattn._fused_block_applicable(narrow, x, None, None, None)  # head width 8
    assert kb.kernel_takes(129, 1280, 8, 96, 1536) and kb.kernel_takes(128, 1152, 8, 96, 2048)


def test_module_operands_are_cached_until_a_parameter_changes():
    block = tattn.ParallelTransformerBlock(C, MLP, H, QKV, fused_block=True, device="cpu")
    tattn.reset_parameters(block, torch.Generator().manual_seed(0))
    first = kb._operands(block)
    assert kb._operands(block) is first
    block.load_state_dict(params_from_flax(_block_tree(3)))  # in place: versions move
    second = kb._operands(block)
    assert second is not first
    assert torch.equal(second["wqkv_t"], kb.flatten_block_params(block.state_dict())["wqkv_t"])


def _model_pair(overrides, monkeypatch):
    monkeypatch.setattr(jax_kernels, "INTERPRET_DEFAULT", True)
    params = _perturbed(tiny_model_3d(T, device="cpu", seed=1, qkv_size=QKV).state_dict(), 1,
                        scale=0.05)
    batch = synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T,
                            with_features=True)
    jdtype = overrides.pop("dtype", None)
    jkw = dict(overrides, **({"dtype": jnp.bfloat16} if jdtype else {}))
    want = jax.jit(jax_tiny_model_3d(T, qkv_size=QKV, fused_block=True, **jkw).apply)(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    tkw = dict(overrides, **({"dtype": torch.bfloat16} if jdtype else {}))
    model = tiny_model_3d(T, device="cpu", qkv_size=QKV, fused_block=True, **tkw)
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = model(to_torch(batch))
    return got, want


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_tiny_fused_block_model_matches_jax(precision, monkeypatch):
    overrides = {} if precision == "f32" else {"dtype": "bf16", "fused_attention": True}
    got, want = _model_pair(overrides, monkeypatch)
    scale = float(np.abs(np.asarray(want.tracks)).max())
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=5e-2 * scale)
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name), np.float32), **tol,
                                   err_msg=name)


def test_cpu_dispatch_launches_nothing_and_refuses_other_dtypes():
    tree = params_from_flax(_block_tree())
    before = kb.fused_transformer_block.launches
    kb.fused_transformer_block(torch.from_numpy(_x()), tree, H)
    assert kb.fused_transformer_block.launches == before
    with pytest.raises(ValueError, match="out_dtype"):
        kb.fused_transformer_block(torch.from_numpy(_x()), tree, H, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="does not fit"):
        kb.fused_transformer_block(torch.zeros(2, S, C + 8), tree, H)


def test_stage_bits_cover_the_seven_launches():
    """``launch_stages`` names the C entry point's launches by bit: each of the
    ``KERNELS_PER_CALL`` bits gates one launch, and ``ALL_STAGES`` sets them all."""
    src = (Path(kb.build.CSRC) / "block.cu").read_text()
    bits = sorted({int(b) for b in re.findall(r"stages & (\d+)\)", src)})
    assert bits == [1 << i for i in range(kb.KERNELS_PER_CALL)] == [1, 2, 4, 8, 16, 32, 64]
    assert kb.ALL_STAGES == sum(bits) and len(kb.STAGES) == kb.KERNELS_PER_CALL


@pytest.mark.parametrize("head_dim", kb.HEAD_DIMS)
def test_qkv_gemm_tiles_hold_whole_heads_and_fit_shared_memory(head_dim):
    """The Q/K/V GEMM's N tile holds whole heads (its RMSNorm epilogue needs a
    head's row), is a wgmma width the source defines, and every GEMM
    instantiation's shared memory fits an H100 block (232,448 bytes): the
    cooperative Q/K/V GEMM, and the ping-pong ones (out-projection: bf16
    residual, f32 y; MLP in: bf16 out; MLP out: f32 residual, f32 or bf16 out)."""
    src = (Path(kb.build.CSRC) / "block.cu").read_text()
    wide, narrow = map(int, re.search(r"BN = DH == 96 \? (\d+) : (\d+);", src).groups())
    bn = wide if head_dim == 96 else narrow
    assert bn % head_dim == 0 and bn <= 256
    sm90 = (Path(kb.build.CSRC) / "sm90.cuh").read_text()
    assert f"struct Wgmma<{bn}> {{" in sm90 and f"float (&d)[{bn // 2}]" in sm90
    limit = int(re.search(r"SMEM_LIMIT = (\d+);", src).group(1))
    assert limit == kb.SMEM_LIMIT == 232448
    stages = int(re.search(r"G_STAGES = (\d+);", src).group(1))
    assert 1024 + stages * (128 + bn) * 128 + 2 * 64 * bn * 2 + 2 * stages * 8 <= limit
    # Ping-pong: a 4-stage ring of 128 x 64 (or 64 x 64) A and 128 x 64 B
    # tiles, and an epilogue buffer of one 64-row half per consumer
    # warpgroup: 32 KB for a residual or f32 out, 16 KB for GELU's bf16 out.
    big, small = map(int, re.search(r"HALF = RESID \|\| !OUT_BF16 \? (\d+) : (\d+);",
                                    src).groups())
    assert (big, small) == (32768, 16384)
    depth = int(re.search(r"static constexpr int STAGES = (\d+);", src).group(1))
    assert 'BYTES = 1024 + static_cast<size_t>(STAGES) * (BM + BN) * 128 +\n' \
           '                                  2 * static_cast<size_t>(HALF) + (2 * STAGES + 4)' in src
    for rows in (128, 64):
        for half in (big, small):
            smem = 1024 + depth * (rows + 128) * 128 + 2 * half + (2 * depth + 4) * 8
            assert depth >= 4 and smem <= limit, (rows, half, smem)
    # The residual's boxes fit the half they land in: f32 in four 8 KB boxes
    # from byte 0, bf16 in two from byte 16384.
    assert 4 * 8192 <= big and 16384 + 2 * 8192 <= big


@pytest.mark.parametrize("head_dim", kb.HEAD_DIMS)
def test_attention_stage_fits_shared_memory_at_max_seq(head_dim):
    """At S = MAX_SEQ (256), the attention stage's q, k and v tiles of one
    (item, head) (head_dim / 32 boxes of 32 columns, 256 rows of 64 bytes)
    and their barriers fit an H100 block's 232,448 bytes; two buffers where
    two fit. ``attention_plan`` follows the source's layout."""
    src = (Path(kb.build.CSRC) / "block.cu").read_text()
    assert "static constexpr int ROWS = 64 * KT;" in src
    assert "static constexpr int BOXB = ROWS * 64;" in src
    assert "static constexpr int TILE = NBX * BOXB;" in src
    assert "static constexpr int ITEM = 3 * TILE;" in src
    assert "static constexpr int BARS = 3;" in src
    assert "BUFS = 1024 + 2 * (ITEM + BARS * 8) <= SMEM_LIMIT ? 2 : 1;" in src
    assert "BYTES = 1024 + static_cast<size_t>(BUFS) * (ITEM + BARS * 8);" in src
    assert f"A_CONSUMERS = {kb.ATTENTION_CONSUMERS};" in src
    assert "return KT <= 3 && NBX <= 3 ? A_CONSUMERS : 2;" in src
    plan = kb.attention_plan(1, kb.MAX_SEQ, 1, head_dim, 132)
    item = 3 * (head_dim // 32) * 256 * 64 + 3 * 8
    assert plan["buffers"] == (2 if 1024 + 2 * item <= 232448 else 1)
    assert plan["smem_bytes"] == 1024 + plan["buffers"] * item <= 232448
    assert plan["buffers"] == {32: 2, 64: 2, 96: 1, 128: 1}[head_dim]


@pytest.mark.parametrize("seq", [1, 129, 192, 193, 256])
def test_attention_stage_launch_arithmetic(seq):
    """One work item per (item, head), its q, k and v loaded once; 64-row
    query slabs dealt to the warpgroups in turn (three up to S = 192 with heads
    of 96; two beyond, two slabs each), ceil(S / 64) key tiles in one pass; a
    persistent grid of at most one block per SM. The source dispatches on the
    same key-tile count and deals the slabs the same way."""
    src = (Path(kb.build.CSRC) / "block.cu").read_text()
    assert "switch ((S + 63) / 64) {" in src
    assert "const int slabs = (S + 63) / 64;" in src
    assert "for (int slab = c; slab < slabs; slab += WGS) {" in src
    assert "const int work = items * H;" in src
    assert "const int grid = work < sms ? work : sms;" in src
    tiles = {1: 1, 129: 3, 192: 3, 193: 4, 256: 4}[seq]
    deal = {1: [1, 0, 0], 129: [1, 1, 1], 192: [1, 1, 1], 193: [2, 2], 256: [2, 2]}[seq]
    for items, heads, sms in ((512, 8, 132), (1, 8, 132), (3, 2, 132)):
        plan = kb.attention_plan(items, seq, heads, 96, sms)
        assert plan["work"] == items * heads and plan["grid"] == min(items * heads, sms)
        assert plan["key_tiles"] == plan["query_slabs"] == tiles
        assert plan["slabs_per_warpgroup"] == deal and sum(deal) * 64 >= seq > (sum(deal) - 1) * 64
        assert plan["warpgroups"] == len(deal)
        assert plan["kv_loads"] == 1
        assert plan["buffers"] == (2 if seq <= 192 else 1)
