"""Host-to-device prefetch (port of ``tdspa/data/prefetch.py``).

Keeps ``buffer_size`` batches in flight so that host-side batch preparation
overlaps device compute: on a CUDA device each array is copied into pinned
host memory and sent with a ``non_blocking`` copy on the current stream,
which later kernels on that stream wait for.
"""

from __future__ import annotations

import collections
import itertools

import numpy as np
import torch

from tdspa_torch.utils.device import resolve_device


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    out = {}
    for key, value in batch.items():
        tensor = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
        if device.type == "cuda" and tensor.device.type == "cpu":
            tensor = tensor.pin_memory()
        out[key] = tensor.to(device, non_blocking=True)
    return out


def device_prefetch(iterator, buffer_size: int = 2, device="cuda"):
    """Yield the batches of ``iterator`` on ``device`` (GPU unless
    ``device="cpu"``), keeping ``buffer_size`` of them enqueued ahead."""
    device = resolve_device(device)
    iterator = iter(iterator)
    queue = collections.deque(
        to_device(batch, device) for batch in itertools.islice(iterator, buffer_size)
    )
    while queue:
        out = queue.popleft()
        for batch in itertools.islice(iterator, 1):
            queue.append(to_device(batch, device))
        yield out
