"""Sharding specs for model batches, and each rank's slice of a batch (port
of ``tdspa/parallel/shardings.py``).

A spec is a plain per-key description of which dim goes over which mesh
axes: a tuple with one entry per leading dim, each ``None`` (whole),
an axis name, or a tuple of axis names (sharded over them jointly,
the first one major). Dims past the tuple, and keys without a spec, are
whole (replicated).

Layout policy (JAX's; see mesh.py for the axes):

* training batches: every array sharded on its leading batch dim over
  ``data``; support tracks and queries also over ``seq``;
* parameters and optimizer state: replicated;
* single-video inference: the track and query sets over ('data', 'seq')
  jointly, the batch of one whole.

A rank's slice of a dim is contiguous and the slices follow the ranks'
positions on the axes, so a gather in rank order rebuilds the global order.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from tdspa_torch.parallel.mesh import axis_index, gather_differentiable


def replicated() -> tuple:
    """Whole on every rank."""
    return ()


def batch_sharding(data_axis: str = "data") -> tuple:
    """Leading-dim batch sharding."""
    return (data_axis,)


def train_batch_spec(seq_shard: bool = True) -> dict:
    """Specs per batch key for the training step: batch over ``data``; the
    track and query sets over ``seq`` when ``seq_shard``."""
    set_axis = "seq" if seq_shard else None
    return {
        "support_tracks": ("data", set_axis),
        "support_tracks_visible": ("data", set_axis),
        "query_points": ("data", set_axis),
        "query_tracks": ("data", set_axis),
        "query_tracks_visible": ("data", set_axis),
        "boundary_frame": ("data",),
        "dino_features": ("data", set_axis),
        "depth_features": ("data", set_axis),
    }


def query_sharded_batch_spec() -> dict:
    """Single-video inference: batch 1 whole; the support tracks and the
    query points over ('data', 'seq') jointly."""
    both = ("data", "seq")
    return {
        "support_tracks": (None, both),
        "support_tracks_visible": (None, both),
        "query_points": (None, both),
        "query_tracks": (None, both),
        "query_tracks_visible": (None, both),
        "boundary_frame": (None,),
        "dino_features": (None, both),
        "depth_features": (None, both),
    }


def shard_index(mesh: DeviceMesh, axes) -> tuple[int, int]:
    """(this rank's position, number of shards) over ``axes`` (None, a name
    or a tuple of names, the first major)."""
    if axes is None:
        return 0, 1
    index, count = 0, 1
    for axis in (axes,) if isinstance(axes, str) else axes:
        index = index * mesh.size(mesh.mesh_dim_names.index(axis)) + axis_index(mesh, axis)
        count *= mesh.size(mesh.mesh_dim_names.index(axis))
    return index, count


def local_slice(x: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Shard ``index`` of ``count`` contiguous shards of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % count:
        raise ValueError(f"dim {dim} of size {size} does not divide into {count} shards")
    part = size // count
    return x.narrow(dim, index * part, part)


def shard_batch(mesh: DeviceMesh, batch: dict, specs: dict | None = None,
                num_microbatches: int = 1) -> dict:
    """This rank's slice of a global batch (numpy arrays or tensors) under
    the given (or the training) specs, as contiguous tensors on the batch's
    device.

    With ``num_microbatches`` > 1 the leading dim is laid out as the gradient
    accumulation's ``[microbatches, B / microbatches]`` and sharded within
    each microbatch, which stays whole (``tdspa/train/step.py`` keeps the
    scan axis unsharded): the rank's local microbatch i is its slice of the
    global microbatch i.
    """
    specs = train_batch_spec() if specs is None else specs
    out = {}
    for key, value in batch.items():
        x = torch.as_tensor(value)
        spec = specs.get(key, ())
        m = num_microbatches
        if m > 1:
            if x.shape[0] % m:
                raise ValueError(f"{key}: batch {x.shape[0]} does not divide into "
                                 f"{m} microbatches")
            x = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        for dim, axes in enumerate(spec):
            x = local_slice(x, dim + (m > 1), *shard_index(mesh, axes))
        if m > 1:
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        out[key] = x.contiguous()
    return out


def model_kwargs(mesh: DeviceMesh, model, batch: dict) -> dict:
    """The keyword arguments of a model's forward on this rank's shard of a
    training batch (``train_batch_spec``): its readout tokens gathered over
    ``seq`` (differentiably; every rank of a ``seq`` group then holds the
    same latents) and its rows of the whole batch's dither."""
    support = batch["support_tracks"].shape[1]
    chunk = model.encoder_scan_chunk_size
    if chunk is not None and support % chunk:
        raise ValueError(f"encoder_scan_chunk_size={chunk} must divide each rank's {support} "
                         f"support tracks (the batch's support set over seq)")
    rows = batch["support_tracks"].shape[0]
    index, count = shard_index(mesh, "data")
    group = mesh.get_group("seq")
    return {"gather_tokens": lambda tokens: gather_differentiable(tokens, group, dim=1),
            "dither_rows": (index * rows, count * rows)}
