"""What the drivers share: the program's model from a configuration file,
the gaps the checks compare, and the precision switch of the reference."""

from __future__ import annotations

import inspect
import statistics
import time

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Stopwatch:
    """Seconds of each part of a set-up, in order, for an earlier line."""

    def __init__(self):
        self.parts: dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self._last
        self._last = now


def program_model(config: dict, device):
    """The port's model of ``config["architecture"]``, built with every key
    of the file its constructor takes (dtype names mapped to dtypes)."""
    from tdspa_torch import models

    cls = getattr(models, config["architecture"])
    accepted = inspect.signature(cls).parameters
    kwargs = {k: DTYPES.get(v, v) if k.endswith("dtype") else v
              for k, v in config.items() if k in accepted}
    return cls(device=device, **kwargs)


def sync(device, empty_cache: bool = False) -> None:
    """Wait for the card (nothing on the CPU); optionally return its cached
    memory."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        if empty_cache:
            torch.cuda.empty_cache()


def reference_mode(on: bool = True) -> None:
    """Full float32 products for the reference (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def worst_row(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap of a row (a query: axis 1, over its frames and channels)
    over the median row's norm in the reference."""
    want = want.float().flatten(2)
    gap = torch.linalg.vector_norm(got.float().flatten(2) - want, dim=-1)
    return float(gap.max() / torch.linalg.vector_norm(want, dim=-1).median())


def leaf_gaps(got: dict, want: dict, keep=None) -> list[float]:
    """Each leaf's gap between two norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    leaves = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in leaves)
    return [abs(got[k] - want[k]) / max(want[k], median) for k in leaves]


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    return max(leaf_gaps(got, want, keep))


def median_leaf(got: dict, want: dict, keep=None) -> float:
    return statistics.median(leaf_gaps(got, want, keep))


def seeded_order(count: int, seed: int) -> list[int]:
    gen = torch.Generator().manual_seed(seed % (2 ** 63))
    return torch.randperm(count, generator=gen).tolist()
