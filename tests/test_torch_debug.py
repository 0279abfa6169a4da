"""The port's NaN debugging (``utils/debug.py``, ``profiling.debug_nans``) and
its stage timer and first-call timer (``utils/profiling.py``) against the
JAX package's.

JAX's ``jax_debug_nans`` raises ``FloatingPointError`` at the primitive that
produced a NaN; the port's ``NanCheckMode`` raises it at the first operator
whose floating output holds one, naming the operator (a ``tdspa::`` custom
op as itself). Outputs under the mode equal those without it (the mode only
reads them).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from tdspa.utils import profiling as jprofiling
from tdspa_torch.cli import evaluate as evaluate_cli
from tdspa_torch.cli import infer as infer_cli
from tdspa_torch.cli import train as train_cli
from tdspa_torch.infer.pipeline import fused_tail
from tdspa_torch.kernels import ops
from tdspa_torch.utils import debug, profiling
from tdspa_torch.utils.testing import tiny_model_3d

T, H, W = 8, 24, 24
N_TRACKS, N_SUPPORT, N_QUERIES = 16, 8, 4


def test_a_nan_from_a_plain_op_raises_like_jax():
    x = np.array([1.0, -1.0, 4.0], np.float32)
    with jprofiling.debug_nans(True), pytest.raises(FloatingPointError):
        jax.jit(jnp.log)(jnp.asarray(x)).block_until_ready()
    with profiling.debug_nans(True):
        with pytest.raises(FloatingPointError, match=r"aten\.log\.default"):
            torch.log(torch.from_numpy(x))
        # Infinities are not NaNs, as in JAX.
        assert torch.isinf(torch.from_numpy(x) / 0).any()


def test_a_nan_from_a_custom_op_names_the_op():
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.standard_normal((2, 4, 4, 3)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(0, 3, (5, 2, 2)).astype(np.float32))
    with profiling.debug_nans():
        clean = ops.bilinear_sample(grid, coords, torch.float32)
    torch.testing.assert_close(clean, ops.bilinear_sample(grid, coords, torch.float32),
                               rtol=0, atol=0)
    grid[:, :, :, 1] = float("nan")
    with profiling.debug_nans(), pytest.raises(FloatingPointError,
                                               match=r"tdspa\.bilinear_sample\.default"):
        ops.bilinear_sample(grid, coords, torch.float32)


def _tail_inputs():
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.uniform(0, W - 1.0, (N_TRACKS, T, 2)).astype(np.float32)),
            torch.from_numpy((rng.uniform(size=(N_TRACKS, T, 1)) > 0.2).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((T, 2, 2, 768)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 4.0, (T, H, W, 1)).astype(np.float32)))


def test_the_tail_under_debug_nans():
    """The tiny default tail: the same outputs under the mode; a NaN in one
    DINO feature is named at the DINO sampling, the bilinear custom op."""
    model = tiny_model_3d(T, device="cpu", seed=3)
    args = _tail_inputs()
    perm = torch.from_numpy(np.random.default_rng(2).permutation(N_TRACKS))
    ts = torch.from_numpy(np.random.default_rng(3).integers(0, T, N_QUERIES))
    split = (perm, ts, N_SUPPORT, N_QUERIES, (H, W))
    with torch.no_grad():
        want, _, _ = fused_tail(model, *args, *split)
        with profiling.debug_nans():
            got, _, _ = fused_tail(model, *args, *split)
        torch.testing.assert_close(got.tracks, want.tracks, rtol=0, atol=0)
        args[2][3, 1, 0, 5] = float("nan")
        with profiling.debug_nans(), pytest.raises(
                FloatingPointError, match=r"tdspa\.bilinear_sample\.default"):
            fused_tail(model, *args, *split)
        # Off, the NaN flows through and nothing is checked.
        out, _, _ = fused_tail(model, *args, *split)
        assert torch.isnan(out.tracks).any()


def test_off_installs_nothing_and_enable_toggles():
    assert _get_current_dispatch_mode_stack() == []
    with profiling.debug_nans(False):
        assert _get_current_dispatch_mode_stack() == []
    with profiling.debug_nans(True):
        assert [type(m) for m in _get_current_dispatch_mode_stack()] == [debug.NanCheckMode]
    assert _get_current_dispatch_mode_stack() == []
    debug.enable_debug_nans(True)
    try:
        debug.enable_debug_nans(True)  # idempotent, as a config flag
        assert len(_get_current_dispatch_mode_stack()) == 1
        with pytest.raises(FloatingPointError):
            torch.tensor([0.0]) / torch.tensor([0.0])
    finally:
        debug.enable_debug_nans(False)
    assert _get_current_dispatch_mode_stack() == []
    torch.tensor([0.0]) / torch.tensor([0.0])  # off: no raise


def test_the_three_clis_parse_the_flag():
    for cli, base in ((infer_cli, []), (evaluate_cli, []), (train_cli, [])):
        parser = cli.build_parser()
        assert parser.parse_args(base + ["--debug_nans"]).debug_nans is True
        assert parser.parse_args(base + ["--nodebug_nans"]).debug_nans is False
        assert parser.parse_args(base).debug_nans is False


def test_stage_timer_accumulates_like_jax():
    got, want = {}, {}
    for sink, timer in ((got, profiling.stage_timer), (want, jprofiling.stage_timer)):
        for _ in range(2):
            with timer("tail", sink):
                time.sleep(0.01)
        with timer("upload", sink):
            pass
        with timer("unsunk"):
            pass
    assert got.keys() == want.keys() == {"tail", "upload"}
    assert got["tail"] >= 0.02 and want["tail"] >= 0.02
    assert 0.0 <= got["upload"] < got["tail"]


def test_log_compile_time_returns_first_steady_and_the_output():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    x = np.arange(4, dtype=np.float32)
    first, steady, out = profiling.log_compile_time(fn, torch.from_numpy(x), iters=2, scale=3.0)
    jfirst, jsteady, jout = jprofiling.log_compile_time(jax.jit(lambda x: x * 3.0),
                                                        jnp.asarray(x), iters=2)
    assert len(calls) == 3  # one first call and ``iters`` steady ones, as in JAX
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert all(isinstance(v, float) and v >= 0 for v in (first, steady, jfirst, jsteady))
