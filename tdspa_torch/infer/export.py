"""Serving export: the fused inference tail as a ``torch.export`` artifact (port
of ``tdspa/infer/export.py``).

The fused tail (lift + sample + split + autoencode, ``pipeline.py::
fused_tail``) is the one device program a serving deployment runs per video
once the per-frame features exist. This module exports it, bound to static
serving shapes, with ``torch.export.export`` to a ``.pt2`` file
(``torch.export.save``) and a JSON manifest at ``<path>.json``, so a server
can ``load_exported(path).call(params, ...)`` without the model's source. The
kernels the tail reaches stay in the graph as the ``tdspa::`` custom ops of
``kernels/ops.py`` (attention, bilinear sampling, and the int8 or fused-block
kernels of the two serving configurations); loading registers them and
imports no model module.

Differences from the JAX module, each by necessity:

* **Injected split.** The calling convention is ``fn(params, perm, ts,
  tracks_2d, visible, [dino_grid], [depth_maps])``: the support/query split's
  permutation and query frames are inputs (``InferencePipeline.
  split_indices`` draws them), since a torch graph cannot reproduce
  ``jax.random.permutation`` from JAX's ``seed``.
* **Weight-free, as in JAX.** ``params`` is the model's flax-named state dict,
  bound through ``torch.func.functional_call``, so one artifact serves every
  checkpoint of the same layout.
* **``device`` in place of ``platforms``.** ``"cuda"`` (the default) or
  ``"cpu"``. Tracing runs on fake tensors of that device
  (``FakeTensorMode``), so a CUDA artifact can be exported on a host without
  a GPU, as JAX lowers for a TPU from a CPU host.
* No counterpart of ``register_result_serialization``: the programs return
  plain dicts.
* **Mesh artifacts** (``export_mesh_tail``): one program for every rank of
  a ``torch.distributed`` group. Its gathers are traced as the
  ``_c10d_functional`` collectives over the default group, which
  ``torch.export`` keeps, and the rank's position is an input: the
  calling convention, through ``call_exported_mesh``, stays ``fn(params,
  perm, ts, tracks_2d, visible, [dino_grid], [depth_maps])``. The artifact is
  tied to its world size (JAX's ``nr_devices``, in the manifest and read
  from the graph): a call from another world size is refused.
"""

from __future__ import annotations

import json
import os

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.export.graph_signature import InputKind
from torch.overrides import TorchFunctionMode

from tdspa_torch.kernels import ops  # noqa: F401  (registers the tdspa:: ops)

MANIFEST_SUFFIX = ".json"


class _Bound:
    """The model with ``params`` in place of its own parameters, callable as
    the model is (``torch.func.functional_call``)."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def __call__(self, batch, **kwargs):
        return torch.func.functional_call(self.model, self.params, (batch,), kwargs)


def make_serving_fn(model, num_support: int, num_queries: int, video_hw: tuple, use_dino: bool,
                    use_depth: bool):
    """The export-shaped wrapper around ``fused_tail``::

        fn(params, perm, ts, tracks_2d, visible, [dino_grid], [depth_maps])

    (feature arguments only where enabled). Returns a plain dict: the
    predicted ``tracks`` / ``visible_logits`` / ``certain_logits``, the
    sampled ``query_points``, the lifted ``tracks_3d`` and both sides of the
    split (``support_tracks``, ``query_tracks``).
    """
    # Deferred so that a server imports this module for load_exported()
    # without the model stack.
    from tdspa_torch.infer.pipeline import fused_tail

    def fn(params, perm, ts, tracks_2d, visible, *features):
        features = list(features)
        dino_grid = features.pop(0) if use_dino else None
        depth_maps = features.pop(0) if use_depth else None
        return _outputs(*fused_tail(
            _Bound(model, params), tracks_2d, visible, dino_grid, depth_maps, perm, ts,
            num_support, num_queries, tuple(video_hw), use_dino, use_depth,
        ))

    return fn


def _outputs(preds, batch, tracks_3d) -> dict:
    return {
        "tracks": preds.tracks,
        "visible_logits": preds.visible_logits,
        "certain_logits": preds.certain_logits,
        "query_points": batch["query_points"],
        "tracks_3d": tracks_3d,
        "support_tracks": batch["support_tracks"],
        "query_tracks": batch["query_tracks"],
    }


class _Program(torch.nn.Module):
    """``fn`` as a module with no parameters of its own (the model is not a
    submodule, so its weights stay out of the artifact)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _NoDeviceGuard(TorchFunctionMode):
    """Indexing (``x[...]``) and ``contiguous()`` written as the aten ops they
    stand for, while a program is traced.

    These two tensor methods set a device guard before they dispatch, which a
    PyTorch built without CUDA cannot do for a (fake) CUDA tensor; the aten
    ops ``unsqueeze``, ``slice``, ``select``, ``index`` and ``clone`` need no
    guard. The indexing covered is what the port's programs use: ints,
    slices, ``None`` and ``...``, or slices with integer tensors.
    """

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        if func is torch.Tensor.contiguous and not kwargs and len(args) == 1:
            x = args[0]
            return x if x.is_contiguous() else torch.ops.aten.clone.default(
                x, memory_format=torch.contiguous_format)
        return func(*args, **(kwargs or {}))


def _getitem(x, index):
    aten = torch.ops.aten
    index = index if isinstance(index, tuple) else (index,)
    if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
        raise NotImplementedError("boolean-mask indexing in an exported program")
    if Ellipsis in index:
        at = index.index(Ellipsis)
        used = sum(1 for i in index if i is not None and i is not Ellipsis)
        index = index[:at] + (slice(None),) * (x.dim() - used) + index[at + 1:]
    tensors = any(isinstance(i, torch.Tensor) for i in index)
    if tensors and any(i is None or isinstance(i, int) for i in index):
        raise NotImplementedError("tensor indices beside ints or None in an exported program")
    dim, picks = 0, []
    for i in index:
        if i is None:
            x = aten.unsqueeze.default(x, dim)
            dim += 1
        elif isinstance(i, slice):
            if i != slice(None):
                x = aten.slice.Tensor(x, dim, i.start, i.stop, 1 if i.step is None else i.step)
            picks.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor):
            picks.append(i)
            dim += 1
        else:
            x = aten.select.int(x, dim, int(i))
    return aten.index.Tensor(x, picks) if tensors else x


def _export(fn, args, device):
    """Trace ``fn`` without autograd on fake tensors of ``args``' shapes and
    dtypes on ``device``: nothing is allocated or computed on the device.
    The program keeps no example inputs (they would be those fakes)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake_args = torch.utils._pytree.tree_map_only(
            torch.Tensor, lambda x: torch.empty(x.shape, dtype=x.dtype, device=device), args)
    with torch.no_grad(), _NoDeviceGuard():
        program = torch.export.export(_Program(fn), tuple(fake_args))
    program.example_inputs = None
    return program


def _spec(shape, dtype=torch.float32):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def serving_params(model) -> dict[str, torch.Tensor]:
    """The model's parameters by flax name (its state dict): the ``params`` input."""
    return dict(model.state_dict())


def _tail_specs(params, num_tracks, num_frames, video_hw, num_queries, use_dino, use_depth,
                dino_grid_hw, dino_dim) -> list:
    args = [
        {k: _spec(v.shape, v.dtype) for k, v in params.items()},
        _spec((num_tracks,), torch.int64),  # perm
        _spec((num_queries,), torch.int64),  # ts
        _spec((num_tracks, num_frames, 2)),  # tracks_2d
        _spec((num_tracks, num_frames, 1)),  # visible
    ]
    if use_dino:
        if dino_grid_hw is None:  # DINOv2's patch-14 grid of the patch-multiple resize
            dino_grid_hw = (video_hw[0] // 14, video_hw[1] // 14)
        args.append(_spec((num_frames,) + tuple(dino_grid_hw) + (dino_dim,)))
    if use_depth:
        args.append(_spec((num_frames,) + tuple(video_hw) + (1,)))
    return args


def export_serving_tail(model, params=None, *, num_tracks: int, num_frames: int, video_hw: tuple,
                        num_support: int, num_queries: int, use_dino: bool = True,
                        use_depth: bool = True, dino_grid_hw: tuple | None = None,
                        dino_dim: int = 768, device: str = "cuda"):
    """Trace the fused serving tail to a ``torch.export.ExportedProgram`` for
    ``device`` ("cuda" or "cpu").

    ``params`` (default: the model's own) may be real weights or any mapping
    of tensors with the model's layout: only shapes and dtypes enter the
    artifact, and the weights are inputs of every call.
    """
    params = serving_params(model) if params is None else params
    fn = make_serving_fn(model, num_support, num_queries, video_hw, use_dino, use_depth)
    return _export(fn, _tail_specs(params, num_tracks, num_frames, video_hw, num_queries,
                                   use_dino, use_depth, dino_grid_hw, dino_dim), device)


def export_mesh_tail(mesh, model, num_support: int, num_queries: int, video_hw: tuple,
                     use_dino: bool = True, use_depth: bool = True, *, params=None,
                     num_tracks: int, num_frames: int, dino_grid_hw: tuple | None = None,
                     dino_dim: int = 768, device: str = "cuda"):
    """Trace the multi-GPU fused tail (``pipeline.make_mesh_tail``) for the
    ranks of ``mesh`` (every rank of the process group, in order) to one
    ``ExportedProgram``; every rank may trace it, and each trace is the same.

    The program is ``fn(params, perm, ts, tracks_2d, visible, [dino_grid],
    [depth_maps], shard)`` with ``shard`` the rank's position (an int64 0-d
    tensor); call it through ``call_exported_mesh``, which passes it.
    """
    from tdspa_torch.infer.pipeline import mesh_fused_tail
    from tdspa_torch.parallel.mesh import world_group

    group = world_group(mesh)
    count = torch.distributed.get_world_size(group)
    if num_support % count or num_queries % count or num_tracks % count:
        raise ValueError(f"num_tracks={num_tracks}, num_support={num_support} and "
                         f"num_queries={num_queries} must divide by the mesh's {count} ranks")
    params = serving_params(model) if params is None else params

    def fn(params, perm, ts, tracks_2d, visible, *rest):
        *features, shard = rest
        dino_grid = features.pop(0) if use_dino else None
        depth_maps = features.pop(0) if use_depth else None
        return _outputs(*mesh_fused_tail(
            _Bound(model, params), group, shard, tracks_2d, visible, dino_grid, depth_maps,
            perm, ts, num_support, num_queries, tuple(video_hw), use_dino, use_depth))

    args = _tail_specs(params, num_tracks, num_frames, video_hw, num_queries, use_dino,
                       use_depth, dino_grid_hw, dino_dim) + [_spec((), torch.int64)]
    return _export(fn, args, device)


def nr_devices(program) -> int | None:
    """The group size the program's collectives were traced for (None
    without collectives)."""
    sizes = {n.args[1] for n in program.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("_c10d_functional.all_gather_into_tensor")}
    if len(sizes) > 1:
        raise ValueError(f"collectives over groups of several sizes: {sorted(sizes)}")
    return sizes.pop() if sizes else None


def tail_config(model, *, num_tracks: int, num_frames: int, video_hw: tuple, num_support: int,
                num_queries: int, use_dino: bool, use_depth: bool, device: str) -> dict:
    """The configuration an exported tail is bound to, for its manifest:
    the shapes, the features, the model's serving knobs and dtypes, and the
    device. ``InferencePipeline(tail_artifact=...)`` refuses an artifact
    whose manifest disagrees with it."""
    return {
        "num_output_frames": num_frames, "video_hw": list(video_hw), "num_tracks": num_tracks,
        "num_support": num_support, "num_queries": num_queries, "use_dino": use_dino,
        "use_depth": use_depth, "quantize": model.quantize, "fused_block": model.fused_block,
        "bf16_residual": model.residual_dtype == torch.bfloat16,
        "dtype": str(model.dtype).removeprefix("torch."), "device": device,
    }


def export_model_forward(model, params, example_batch: dict, device: str = "cuda"):
    """Export a bare model forward (TRAJAN-2D or 3DSPA): ``call(params,
    batch)`` -> dict of ``tracks`` / ``visible_logits`` / ``certain_logits``.
    ``example_batch`` fixes the batch's keys, shapes and dtypes."""
    def fn(params, batch):
        res = _Bound(model, params)(batch)
        return {"tracks": res.tracks, "visible_logits": res.visible_logits,
                "certain_logits": res.certain_logits}

    specs = [{k: _spec(v.shape, v.dtype) for k, v in params.items()},
             {k: _spec(v.shape, v.dtype) for k, v in example_batch.items()}]
    return _export(fn, specs, device)


def _param_names(program) -> list[str] | None:
    """The keys of the program's first argument where it is a dict (the
    params), in the order of its input spec."""
    spec = program.call_spec.in_spec
    args, _ = torch.utils._pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
    return list(args[0]) if args and isinstance(args[0], dict) else None


def save_exported(exported, path: str, extra_manifest: dict | None = None) -> dict:
    """Write the artifact to ``path`` (``torch.export.save``) and its manifest
    to ``path + ".json"``; returns the manifest."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    names = _param_names(exported)
    inputs = [n.meta["val"] for n in exported.graph.nodes if n.op == "placeholder"
              and n.name in {s.arg.name for s in exported.graph_signature.input_specs
                             if s.kind == InputKind.USER_INPUT}]
    args = inputs[len(names or ()):]
    manifest = {
        "format": "torch.export .pt2",
        "torch_version": torch.__version__,
        "device": inputs[0].device.type if inputs else None,
        "nr_args": len(args) + (names is not None),
        "param_names": names or [],
        "in_avals": [f"{str(x.dtype).removeprefix('torch.')}{list(x.shape)}" for x in args],
        "nr_outputs": len(exported.graph_signature.output_specs),
        "tdspa_ops": sorted({str(n.target) for n in exported.graph.nodes
                             if n.op == "call_function" and str(n.target).startswith("tdspa.")}),
        "nr_devices": nr_devices(exported),
        "bytes": os.path.getsize(path),
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(path + MANIFEST_SUFFIX, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class LoadedProgram:
    """A loaded artifact: ``call(*args)`` runs it; ``program`` is the
    ``ExportedProgram``. The params dict may come in any key order: ``call``
    lays it out in the exported order, which the program's input check
    requires."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()
        self._param_names = _param_names(program)
        self.nr_devices = nr_devices(program)

    def call(self, *args):
        if self._param_names is not None:
            args = ({k: args[0][k] for k in self._param_names},) + tuple(args[1:])
        return self._module(*args)


def load_exported(path: str) -> LoadedProgram:
    """Load an artifact; run it via ``.call(params, perm, ts, tracks_2d,
    visible, [dino_grid], [depth_maps])`` (or ``.call(params, batch)`` for a
    model forward). Imports no model module."""
    return LoadedProgram(torch.export.load(path))


def load_exported_mesh(path: str) -> LoadedProgram:
    """Load a mesh artifact (``export_mesh_tail``); call it through
    ``call_exported_mesh`` on a live mesh of its world size. Imports no model
    module."""
    loaded = load_exported(path)
    if loaded.nr_devices is None:
        raise ValueError(f"{path} holds no collectives: not a mesh artifact")
    return loaded


def call_exported_mesh(exported: LoadedProgram, mesh, params, perm, ts, tracks_2d, visible,
                       *features) -> dict:
    """Run a loaded mesh artifact on this rank of ``mesh``, which must hold
    every rank of a process group of the artifact's world size
    (``ValueError`` otherwise); ``perm`` and ``ts`` must be the same on every
    rank. Every rank returns the whole outputs."""
    world = torch.distributed.get_world_size()
    if exported.nr_devices != world or mesh.mesh.numel() != world:
        raise ValueError(f"the artifact was exported for {exported.nr_devices} ranks; this "
                         f"process group has {world} and the mesh {mesh.mesh.numel()}")
    shard = torch.tensor(torch.distributed.get_rank(), dtype=torch.int64,
                         device=tracks_2d.device)
    return exported.call(params, perm, ts, tracks_2d, visible, *features, shard)


def read_manifest(path: str) -> dict:
    with open(path + MANIFEST_SUFFIX) as f:
        return json.load(f)
