"""NaN debugging (port of ``tdspa/utils/debug.py``).

JAX's ``jax_debug_nans`` re-runs a computation op by op when a NaN appears
and raises at the op that produced it. The port's counterpart is
``NanCheckMode``, a ``TorchDispatchMode`` that checks every floating output
of every operator as it runs (the ``tdspa::`` custom ops included, so a NaN
from a CUDA kernel is named as that op) and raises ``FloatingPointError``
at the first one that holds a NaN. Each check reads one flag back from the
device, so the mode synchronises once per op: a debugging tool, off unless
asked for, and when off nothing is installed. ``--debug_nans`` on the
infer, evaluate and train CLIs turns it on for the run.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` naming the first operator whose floating
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(leaf.shape)}, {leaf.dtype}, "
                    f"{leaf.device})")
        return out


_installed: list[NanCheckMode] = []


def enable_debug_nans(enabled: bool = True) -> None:
    """Install (``enabled``) or remove the NaN check for the calling thread,
    as ``jax.config.update("jax_debug_nans", enabled)`` toggles JAX's.
    Prefer the scoped ``tdspa_torch.utils.profiling.debug_nans``."""
    if enabled and not _installed:
        mode = NanCheckMode()
        mode.__enter__()
        _installed.append(mode)
    elif not enabled and _installed:
        _installed.pop().__exit__(None, None, None)
