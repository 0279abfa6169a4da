"""The serving export of tdspa_torch (``infer/export.py``, ``cli/export.py``,
``InferencePipeline(tail_artifact=...)``) against the live program and
against tdspa's ``jax.export`` artifact, at the tiny shapes of
``tests/unit/test_export.py``.

Tolerances: an artifact against the live program it was traced from, 1e-6
(the same ops on the same inputs; JAX's own round-trip limit); against JAX's
artifact, the port's f32 tail tolerance of ``tests/test_torch_pipeline.py``
(2e-5), given the split indices JAX draws from the same key.
"""

import json
import os
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.infer import export as jax_export
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.cli import export as export_cli
from tdspa_torch.cli import infer as infer_cli
from tdspa_torch.features.depth import ConstantDepthProvider
from tdspa_torch.features.tracks import StaticGridProvider
from tdspa_torch.infer import export
from tdspa_torch.infer.convert import params_to_flax
from tdspa_torch.infer.pipeline import InferencePipeline
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_2d, tiny_model_3d, to_torch

REPO = Path(__file__).resolve().parents[1]
T, H, W = 8, 32, 32
N_TRACKS, N_SUPPORT, N_QUERIES = 16, 8, 4
DINO_HW, DINO_DIM = (4, 4), 8
SHAPES = dict(num_tracks=N_TRACKS, num_frames=T, video_hw=(H, W), num_support=N_SUPPORT,
              num_queries=N_QUERIES, use_dino=True, use_depth=True)
LIVE_TOL = dict(rtol=1e-6, atol=1e-6)
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, W - 1, (N_TRACKS, T, 2)).astype(np.float32),
            (rng.uniform(size=(N_TRACKS, T, 1)) > 0.2).astype(np.float32),
            rng.standard_normal((T,) + DINO_HW + (DINO_DIM,)).astype(np.float32),
            rng.uniform(0.5, 4.0, (T, H, W, 1)).astype(np.float32))


def _jax_split_indices(seed):
    """The permutation and query frames JAX's split draws from PRNGKey(seed)."""
    k_perm, k_frames = jax.random.split(jax.random.PRNGKey(seed))
    perm = np.asarray(jax.random.permutation(k_perm, N_TRACKS)).astype(np.int64)
    ts = np.asarray(jax.random.randint(k_frames, (N_QUERIES,), 0, T)).astype(np.int64)
    return torch.from_numpy(perm), torch.from_numpy(ts)


def _model(**kw):
    return tiny_model_3d(T, device="cpu", dino_feature_dim=DINO_DIM, seed=3, **kw)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The tiny f32 tail exported for the CPU, saved with its manifest and
    loaded back."""
    model = _model()
    path = str(tmp_path_factory.mktemp("export") / "tail.pt2")
    program = export.export_serving_tail(model, dino_grid_hw=DINO_HW, dino_dim=DINO_DIM,
                                         device="cpu", **SHAPES)
    manifest = export.save_exported(program, path, {
        "model": "tiny_3d", **export.tail_config(model, device="cpu", **SHAPES)})
    return model, path, manifest, export.load_exported(path)


def test_roundtrip_matches_live_program(artifact):
    model, path, manifest, loaded = artifact
    params = export.serving_params(model)
    perm, ts = _jax_split_indices(5)
    args = [torch.from_numpy(x) for x in _inputs(1)]
    live = export.make_serving_fn(model, N_SUPPORT, N_QUERIES, (H, W), True, True)(
        params, perm, ts, *args)
    out = loaded.call(dict(reversed(params.items())), perm, ts, *args)  # any key order
    assert set(out) == {"tracks", "visible_logits", "certain_logits", "query_points",
                        "tracks_3d", "support_tracks", "query_tracks"}
    assert out["tracks"].shape == (1, N_QUERIES, T, 3)
    for key in live:
        np.testing.assert_allclose(out[key].numpy(), live[key].numpy(), **LIVE_TOL, err_msg=key)
    other = loaded.call(params, *_jax_split_indices(6), *args)  # the split is an input
    assert not torch.equal(other["query_points"], out["query_points"])

    disk = export.read_manifest(path)
    assert disk == manifest and disk["model"] == "tiny_3d"
    assert disk["nr_args"] == 7 and disk["device"] == "cpu"
    assert disk["param_names"] == list(params)
    assert disk["tdspa_ops"] == ["tdspa.bilinear_sample.default", "tdspa.row_norm.default"]
    assert disk["torch_version"] == torch.__version__
    assert os.path.getsize(path) == disk["bytes"] < 4 * 2 ** 20  # no weights inside


def test_matches_the_jax_artifact(artifact):
    """The same parameters, features and split through both packages' artifacts."""
    model, _, _, loaded = artifact
    flax_params = params_to_flax(model.state_dict())
    jmodel = jax_tiny_model_3d(T, use_dino=True, use_depth=True, dino_feature_dim=DINO_DIM)
    exported = jax_export.export_serving_tail(
        jmodel, flax_params, dino_grid_hw=DINO_HW, dino_dim=DINO_DIM,
        **{k: v for k, v in SHAPES.items()})
    inputs = _inputs(2)
    want = exported.call(flax_params, jnp.uint32(7), *(jnp.asarray(x) for x in inputs))
    got = loaded.call(export.serving_params(model), *_jax_split_indices(7),
                      *(torch.from_numpy(x) for x in inputs))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key], np.float32), **F32_TOL,
                                   err_msg=key)


def test_feature_arguments_dropped_when_disabled():
    model = _model(use_dino=False, use_depth=False)
    program = export.export_serving_tail(
        model, device="cpu", **{**SHAPES, "use_dino": False, "use_depth": False})
    user_inputs = [s for s in program.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
    assert len(user_inputs) == len(export.serving_params(model)) + 4
    tracks, visible, _, _ = _inputs()
    out = program.module()(export.serving_params(model), *_jax_split_indices(0),
                           torch.from_numpy(tracks), torch.from_numpy(visible))
    assert out["tracks"].shape == (1, N_QUERIES, T, 3)
    assert bool(torch.isfinite(out["tracks"]).all())
    np.testing.assert_array_equal(out["tracks_3d"][..., 2].numpy(), 1.0)  # no depth: z = 1


def test_model_forward_export_trajan2d():
    model = tiny_model_2d(T, device="cpu", seed=1)
    batch = to_torch(synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T,
                                     num_coords=2))
    params = export.serving_params(model)
    program = export.export_model_forward(model, params, batch, device="cpu")
    out = program.module()(params, batch)
    with torch.no_grad():
        live = model(batch)
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(out[name].numpy(), getattr(live, name).numpy(), **LIVE_TOL,
                                   err_msg=name)


def test_load_path_needs_no_model_modules(artifact):
    """A server imports infer/export.py for load_exported() only: the model
    and pipeline stack stay out of the process."""
    _, path, _, _ = artifact
    code = (
        "import sys\nfrom tdspa_torch.infer.export import load_exported\n"
        f"program = load_exported({path!r}).program\n"
        "bad = [m for m in sys.modules if m.startswith(('tdspa_torch.models', "
        "'tdspa_torch.infer.pipeline', 'tdspa_torch.core', 'jax', 'tdspa.'))]\n"
        "assert not bad, bad\n"
        "print(sorted({str(n.target) for n in program.graph.nodes if 'tdspa' in str(n.target)}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "tdspa.bilinear_sample.default" in proc.stdout


def test_cuda_artifact_exports_on_a_host_without_a_gpu(tmp_path):
    """Traced on fake CUDA tensors: the kernels stay ``tdspa::`` ops on cuda,
    one per launch the card would make (the counts of the tiny models in
    tests/test_torch_cuda.py: 5 attention + 3 bilinear; quantised 28 int8;
    fused block 2 block + 3 attention; 22 row norms, one a ``_Norm`` of the
    one-layer stacks (4 + 1, 6 + 1 with the latents' cross-attention, 4 + 1,
    4 + 1), 14 where the decompress and readout layers run as fused blocks)."""
    want = {"default": {"fused_masked_attention": 5, "bilinear_sample": 3, "row_norm": 22},
            "quantize": {"fused_masked_attention": 5, "bilinear_sample": 3, "quant_matmul": 28,
                         "row_norm": 22},
            "fused_block": {"fused_masked_attention": 3, "bilinear_sample": 3,
                            "fused_transformer_block": 2, "row_norm": 14}}
    for knob, counts in want.items():
        model = _model(dtype=torch.bfloat16, fused_attention=True, qkv_size=64,
                       **({} if knob == "default" else {knob: True}))
        program = export.export_serving_tail(model, dino_grid_hw=DINO_HW, dino_dim=DINO_DIM,
                                             device="cuda", **SHAPES)
        ops = [n for n in program.graph.nodes if str(n.target).startswith("tdspa.")]
        assert Counter(str(n.target).split(".")[1] for n in ops) == counts, knob
        assert all(n.meta["val"].device.type == "cuda" for n in ops)
    manifest = export.save_exported(program, str(tmp_path / "tail_cuda.pt2"))
    assert manifest["device"] == "cuda"
    assert manifest["tdspa_ops"] == sorted(f"tdspa.{op}.default" for op in want["fused_block"])


def _pipeline(**kwargs):
    return InferencePipeline(**{
        "num_output_frames": T, "num_query_points": N_QUERIES, "num_support_tracks": N_SUPPORT,
        "track_provider": StaticGridProvider(grid_size=4),
        "depth_provider": ConstantDepthProvider(), "dino_extractor": lambda video: _inputs()[2],
        "model": _model(), "dtype": torch.float32, "device": "cpu", **kwargs})


def test_pipeline_runs_the_artifact_and_refuses_a_mismatch(artifact, tmp_path):
    _, path, manifest, _ = artifact
    video = np.random.default_rng(0).integers(0, 255, (T, H, W, 3)).astype(np.uint8)
    want = _pipeline().run_on_frames(video)
    got = _pipeline(tail_artifact=path).run_on_frames(video)
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(getattr(got["predictions"], name).numpy(),
                                   getattr(want["predictions"], name).numpy(), **LIVE_TOL)
    for key in ("tracks_3d", "support_tracks", "query_tracks"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **LIVE_TOL, err_msg=key)

    other = str(tmp_path / "tail.pt2")
    shutil.copy(path, other)
    with open(other + ".json", "w") as f:
        json.dump({**manifest, "quantize": True}, f)
    with pytest.raises(ValueError, match="quantize"):
        _pipeline(tail_artifact=other).run_on_frames(video)
    with pytest.raises(ValueError, match="num_queries"):
        _pipeline(tail_artifact=path, num_query_points=N_QUERIES - 1).run_on_frames(video)
    # A single-device artifact is not a mesh artifact (tests/test_torch_parallel.py).
    with pytest.raises(ValueError, match="not a mesh artifact"):
        export.load_exported_mesh(path)


def test_export_cli_and_the_infer_cli_run_the_artifact(tmp_path):
    """The export CLI's flags become the manifest; the infer CLI's
    ``--tail_artifact`` reaches the pipeline."""
    out = str(tmp_path / "tail.pt2")
    manifest = export_cli.main([
        f"--output_path={out}", "--platforms=cpu", "--tiny_model", f"--num_output_frames={T}",
        f"--video_height={H}", f"--video_width={W}", "--tracking_grid_size=4",
        f"--num_support_tracks={N_SUPPORT}", f"--num_query_points={N_QUERIES}",
        f"--dino_dim={DINO_DIM}", "--nouse_depth", "--quantize"])
    assert (manifest["num_tracks"], manifest["num_support"], manifest["num_queries"]) == (
        N_TRACKS, N_SUPPORT, N_QUERIES)
    assert manifest["quantize"] and not manifest["use_depth"] and manifest["device"] == "cpu"
    assert export.read_manifest(out) == manifest
    args = infer_cli.build_parser().parse_args([f"--tail_artifact={out}", "--device=cpu"])
    infer_cli.check_supported(args)
    assert infer_cli.pipeline_kwargs(args)["tail_artifact"] == out
