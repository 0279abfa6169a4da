"""The seam between tdspa_torch and its CUDA libraries (``kernels/build.py``)
on the CPU: its table of entry points matches the C signatures in
``csrc/*.cu`` and holds every one of them, and every kernel wrapper keeps its
device rule (CPU tensors run the plain version, anything but CPU or CUDA
tensors raises). The kernels themselves load only on a GPU host
(``tests/test_torch_cuda.py``). Imports no JAX.
"""

import ctypes
import functools
import re

import pytest
import torch

from tdspa_torch.kernels import attention, bilinear, block, build, lk, matcher, norm
from tdspa_torch.kernels import quant_matmul, vit_block

_TYPES = {"float": ctypes.c_float, "int": ctypes.c_int}


@functools.cache
def _sources() -> dict:
    """Every ``extern "C" int tdspa_*`` of ``csrc/*.cu``: symbol -> (library,
    the ctypes type of each parameter)."""
    found = {}
    for source in sorted(build.CSRC.glob("*.cu")):
        for symbol, params in re.findall(r'extern "C" int (tdspa_\w+)\(([^)]*)\)',
                                         source.read_text()):
            found[symbol] = (source.stem, [ctypes.c_void_p if "*" in p else _TYPES[p.split()[0]]
                                           for p in params.split(",")])
    return found


@pytest.mark.parametrize("symbol", sorted(build.ENTRIES))
def test_entry_matches_its_c_signature(symbol):
    """The table binds each entry point with its library and argument types."""
    assert build.ENTRIES[symbol] == _sources()[symbol]
    assert build.ENTRIES[symbol][0] in build.KERNELS


def test_every_entry_point_of_the_sources_is_in_the_table():
    assert set(_sources()) == set(build.ENTRIES)
    assert set(build.KERNELS) == {path.stem for path in build.CSRC.glob("*.cu")}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


WRAPPERS = {
    "fused_masked_attention": lambda: attention.fused_masked_attention(
        *(_meta(1, 4, 2, 64, dtype=torch.bfloat16) for _ in range(3))),
    "vit_attention": lambda: attention.vit_attention(
        *(_meta(1, 4, 2, 64, dtype=torch.bfloat16) for _ in range(3))),
    "attention_backward": lambda: attention.attention_backward(
        *(_meta(1, 4, 2, 64, dtype=torch.bfloat16) for _ in range(3)), None, _meta(1, 4, 2, 64)),
    "bilinear_sample": lambda: bilinear.bilinear_sample(_meta(3, 8, 8, 16), _meta(5, 3, 2)),
    "cost_patches_multi": lambda: matcher.cost_patches_multi(
        _meta(3, 8, 8, 16), _meta(5, 2, 16), _meta(5, 3, 2)),
    "track_video_lk_kernel": lambda: lk.track_video_lk_kernel(_meta(3, 16, 16), _meta(5, 2)),
    "row_norm": lambda: norm.row_norm(_meta(3, 64), _meta(64), True, torch.float32),
    "row_norm_backward": lambda: norm.row_norm_backward(_meta(3, 64), _meta(64), _meta(3, 64),
                                                        True),
    "row_norm_backward_summed": lambda: norm.row_norm_backward(
        _meta(3, 64), _meta(64), (_meta(3, 64), _meta(3, 64), _meta(3, 64)), True),
    "row_norm_shared": lambda: norm.row_norm_shared(_meta(3, 64), _meta(64), True,
                                                    torch.bfloat16, 3),
    "quant_matmul": lambda: quant_matmul.quant_matmul(_meta(3, 64), _meta(64, 32)),
    "vit_residual_norm": lambda: vit_block.vit_residual_norm(
        _meta(3, 64), norm=(_meta(64), _meta(64), 1e-6)),
    "swiglu_gate": lambda: vit_block.swiglu_gate(_meta(3, 64), _meta(64)),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_wrappers_refuse_other_devices(wrapper):
    with pytest.raises(ValueError, match="unsupported device meta"):
        WRAPPERS[wrapper]()


def test_device_rule():
    cpu = torch.zeros(2)
    assert build.on_cuda("f", cpu, None, cpu) is False
    with pytest.raises(ValueError, match="different devices"):
        build.on_cuda("f", cpu, _meta(2))


def test_forward_only_refuses_what_autograd_records():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="f is forward-only"):
        build.forward_only("f", None, x)
    with torch.no_grad():
        build.forward_only("f", x)
    build.forward_only("f", x.detach())
