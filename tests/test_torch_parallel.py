"""tdspa_torch.parallel and everything that takes a mesh, at world size 2 on
gloo (CPU), against the port on one device and against the JAX package.

Two groups of two spawned ranks (a ``FileStore`` in ``tmp_path``), each with
a time limit that fails rather than hangs: the training group (mesh
construction, ``shard_batch``, the train, accumulation and eval steps with
``data=2`` and with ``seq=2``, ``train(mesh=)``) and the serving group
(``make_mesh_tail`` in the three serving configurations, the mesh export
round trip). Each rank writes its results to a file; every check is its own
test case over one module-scoped fixture per group. The single-device and
JAX references run in this process.

JAX asserts that its sharded step does not retrace
(``tests/dist/test_pipeline_mesh.py:101-125``). Eager PyTorch traces
nothing; the counterpart asserted here is that a second sharded step
creates no new process group.

Tolerances (``tests/dist/test_sharding.py:51-57`` and
``tests/dist/test_pipeline_mesh.py:54-68``, 237-242): sharded steps against
the single-device step, loss rtol 1e-5 and parameters atol 1e-5; the mesh
tail against ``fused_tail``, tracks_3d and the split atol 1e-5, predictions
atol 2e-4 (the quantised tail also with 99 % of its predictions exact, as
JAX holds its sharded quantised forward); against JAX's ``fused_tail`` in
the same configuration, the predictions within 3 % (tracks) and 5 %
(visibility) of the range. The mesh artifact against the live mesh tail:
bit-equal.
"""

import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tdspa_torch.infer import export
from tdspa_torch.infer.pipeline import fused_tail, make_mesh_tail
from tdspa_torch.parallel import mesh as mesh_lib
from tdspa_torch.parallel.mesh import make_mesh
from tdspa_torch.parallel.shardings import query_sharded_batch_spec, shard_batch
from tdspa_torch.train import step as tstep
from tdspa_torch.train.loop import train
from tdspa_torch.train.state import create_model_state
from tdspa_torch.utils.testing import TINY_3D, synthetic_batch, tiny_model_3d

WORLD = 2
SPAWN_TIMEOUT_S = 120
T, LR = 10, 1e-3
STEP_TOL = dict(loss_rtol=1e-5, param_atol=1e-5)
# The serving tail (tests/dist/test_pipeline_mesh.py's shapes).
H, W = 32, 32
N_TRACKS, N_SUPPORT, N_QUERIES = 64, 32, 16
DINO_HW, DINO_DIM = (4, 4), 8
SERVE_CONFIGS = {"default": {}, "quantize": {"quantize": True},
                 "fused_block": {"fused_block": True}}
TINY_SERVE = dict(qkv_size=64, dino_feature_dim=DINO_DIM)  # head width 32: the block takes it
TRAIN_CHECKS = ["mesh", "shard_batch", "step_data", "step_seq", "grad_accum", "eval_step",
                "no_new_group", "train_loop"]
SERVE_CHECKS = [f"tail_{c}" for c in SERVE_CONFIGS] + ["export_roundtrip"]


# --------------------------------------------------------------------------
# Spawned ranks
# --------------------------------------------------------------------------

def _rank_main(rank, group_name, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    results = {}
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        checks = TRAIN_CHECKS if group_name == "train" else SERVE_CHECKS
        for name, fn in zip(checks, _RANK_CHECKS[group_name](inputs, tmp)):
            try:
                results[name] = fn()
            except Exception:  # reported by the check's own test case
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(tmp, f"result_{rank}.pt"))
        dist.destroy_process_group()


def _spawn(group_name, tmp, inputs) -> list[dict]:
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, group_name, tmp)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        pytest.fail(f"{group_name} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _state(model_type="3dspa"):
    return create_model_state(0, model_type=model_type, learning_rate=LR, warmup_steps=0,
                              total_steps=100, num_output_frames=T, use_dino=True,
                              use_depth=True, device="cpu", **TINY_3D)


class _Recorder:
    """An optimizer that keeps the gradients it is given and updates nothing."""

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        return state


def _step_result(state, metrics):
    return {"loss": float(metrics["train/loss"]),
            "params": {k: v.detach().clone() for k, v in state.params.items()}}


def _train_checks(inputs, tmp):
    batch = inputs["batch"]

    def mesh_checks():
        mesh = make_mesh(seq=2)
        out = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
               "default": tuple(mesh_lib.default_mesh().mesh.shape)}
        for kw in (dict(seq=3), dict(data=2, seq=2), dict(data=3, devices=[0, 1])):
            try:
                make_mesh(**kw)
                out[str(kw)] = "no error"
            except ValueError as e:
                out[str(kw)] = str(e)
        return out

    def shard_checks():
        data, seq = make_mesh(data=2), make_mesh(seq=2)
        return {"data": shard_batch(data, batch), "seq": shard_batch(seq, batch),
                "query": shard_batch(seq, {k: v[:1] for k, v in batch.items()},
                                     query_sharded_batch_spec()),
                "micro": shard_batch(data, batch, num_microbatches=2)}

    def step(mesh_kw):
        def run():
            mesh = make_mesh(**mesh_kw)
            state, model, opt, sched = _state()
            mesh_lib.replicate(list(state.params.values()), mesh)
            state, metrics = tstep.make_train_step(model, opt, sched, mesh=mesh)(
                state, shard_batch(mesh, batch))
            return _step_result(state, metrics)
        return run

    def grad_accum():
        mesh = make_mesh(data=2)
        state, model, _, sched = _state()
        recorder = _Recorder()
        _, metrics = tstep.make_grad_accum_step(model, recorder, sched, num_microbatches=2,
                                                mesh=mesh)(
            state, shard_batch(mesh, batch, num_microbatches=2))
        return {"loss": float(metrics["train/loss"]), "grads": recorder.grads}

    def eval_step():
        mesh = make_mesh(seq=2)
        state, model, _, _ = _state()
        metrics, preds = tstep.make_eval_step(model, mesh=mesh)(
            dict(model.state_dict()), shard_batch(mesh, batch))
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "tracks": preds.tracks}

    def no_new_group():
        mesh = make_mesh(seq=2)
        state, model, opt, sched = _state()
        train_step = tstep.make_train_step(model, opt, sched, mesh=mesh)
        local = shard_batch(mesh, batch)
        state, _ = train_step(state, local)
        groups = len(dist.distributed_c10d._world.pg_map)
        state, _ = train_step(state, local)
        return {"before": groups, "after": len(dist.distributed_c10d._world.pg_map)}

    def train_loop():
        state = train([batch, inputs["batch2"]], model_type="3dspa", num_epochs=1,
                      learning_rate=LR, warmup_steps=1, num_output_frames=T, log_freq=1,
                      checkpoint_dir=os.path.join(tmp, "ck"), save_freq=2, max_steps=2,
                      device="cpu", **TINY_3D)
        dist.barrier()  # rank 0 has written its checkpoint
        return {"params": {k: v.detach().clone() for k, v in state.params.items()},
                "step": state.step, "checkpoints": sorted(os.listdir(os.path.join(tmp, "ck")))}

    return [mesh_checks, shard_checks, step(dict(data=2)), step(dict(seq=2)), grad_accum,
            eval_step, no_new_group, train_loop]


def _serve_model(config):
    model = tiny_model_3d(T, device="cpu", seed=3, **TINY_SERVE, **SERVE_CONFIGS[config])
    model.eval()
    return model


def _serve_checks(inputs, tmp):
    args = inputs["tail_inputs"]
    perm, ts = inputs["perm"], inputs["ts"]

    def tail(config):
        def run():
            mesh = make_mesh(seq=2)
            model = _serve_model(config)
            with torch.no_grad():
                pred, batch, tracks_3d = make_mesh_tail(mesh, model, N_SUPPORT, N_QUERIES,
                                                        (H, W))(*args, perm, ts)
            try:
                make_mesh_tail(mesh, model, N_SUPPORT - 1, N_QUERIES, (H, W))
                refused = "no error"
            except ValueError as e:
                refused = str(e)
            return {"tracks": pred.tracks, "visible_logits": pred.visible_logits,
                    "tracks_3d": tracks_3d, "batch": batch, "refused": refused}
        return run

    def roundtrip():
        mesh = make_mesh(seq=2)
        model = _serve_model("default")
        path = os.path.join(tmp, "mesh_tail.pt2")
        program = export.export_mesh_tail(
            mesh, model, N_SUPPORT, N_QUERIES, (H, W), params=export.serving_params(model),
            num_tracks=N_TRACKS, num_frames=T, dino_grid_hw=DINO_HW, dino_dim=DINO_DIM,
            device="cpu")
        if dist.get_rank() == 0:
            export.save_exported(program, path)
        dist.barrier()
        loaded = export.load_exported_mesh(path)
        with torch.no_grad():
            got = export.call_exported_mesh(loaded, mesh, export.serving_params(model), perm,
                                            ts, *args)
            live_pred, live_batch, live_3d = make_mesh_tail(mesh, model, N_SUPPORT, N_QUERIES,
                                                            (H, W))(*args, perm, ts)
        live = {"tracks": live_pred.tracks, "visible_logits": live_pred.visible_logits,
                "certain_logits": live_pred.certain_logits, "tracks_3d": live_3d,
                **{k: live_batch[k] for k in ("query_points", "support_tracks",
                                              "query_tracks")}}
        return {"got": got, "live": live, "manifest": export.read_manifest(path),
                "nr_devices": loaded.nr_devices}

    return [tail(c) for c in SERVE_CONFIGS] + [roundtrip]


_RANK_CHECKS = {"train": _train_checks, "serve": _serve_checks}


# --------------------------------------------------------------------------
# Fixtures: the spawned groups, and the references in this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train_group"))
    batch = synthetic_batch(0, batch=4, num_support=8, num_queries=4, num_frames=T,
                            with_features=True)
    batch2 = synthetic_batch(1, batch=4, num_support=8, num_queries=4, num_frames=T,
                             with_features=True)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch2 = {k: torch.from_numpy(v) for k, v in batch2.items()}
    ranks = _spawn("train", tmp, {"batch": batch, "batch2": batch2})
    return ranks, batch, batch2


def _tail_inputs():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.uniform(0, W - 1.0, (N_TRACKS, T, 2)).astype(np.float32)),
            torch.from_numpy((rng.uniform(size=(N_TRACKS, T, 1)) > 0.2).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((T,) + DINO_HW + (DINO_DIM,))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 4.0, (T, H, W, 1)).astype(np.float32)))


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    import jax

    tmp = str(tmp_path_factory.mktemp("serve_group"))
    k_perm, k_frames = jax.random.split(jax.random.PRNGKey(7))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, N_TRACKS)).astype(np.int64))
    ts = torch.from_numpy(np.asarray(jax.random.randint(k_frames, (N_QUERIES,), 0, T))
                          .astype(np.int64))
    tail_inputs = _tail_inputs()
    ranks = _spawn("serve", tmp, {"tail_inputs": tail_inputs, "perm": perm, "ts": ts})
    return ranks, tail_inputs, perm, ts, tmp


def _ok(ranks, name):
    for rank, results in enumerate(ranks):
        if "error" in results.get(name, {}):
            pytest.fail(f"rank {rank}, check {name}:\n{results[name]['error']}")
    return [results[name] for results in ranks]


def _single_step(batch):
    state, model, opt, sched = _state()
    state, metrics = tstep.make_train_step(model, opt, sched)(state, dict(batch))
    return _step_result(state, metrics)


def _assert_step_equal(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_TOL["loss_rtol"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.detach().numpy(),
                                   atol=STEP_TOL["param_atol"], rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# The training group's checks
# --------------------------------------------------------------------------

def _check_mesh(ranks, batch, batch2):
    for out in _ok(ranks, "mesh"):
        assert out["shape"] == (1, 2) and out["names"] == ("data", "seq")
        assert out["default"] == (2, 1)
        assert out[str(dict(seq=3))] == "2 devices not divisible by seq=3"
        assert out[str(dict(data=2, seq=2))] == "mesh 2x2 needs 4 devices, have 2"
        assert out[str(dict(data=3, devices=[0, 1]))] == "mesh 3x1 needs 3 devices, have 2"


def _check_shard_batch(ranks, batch, batch2):
    outs = _ok(ranks, "shard_batch")
    for key, value in batch.items():
        # data=2: batch rows; seq=2: the support and query sets; gathered in
        # rank order, each rebuilds the global batch.
        torch.testing.assert_close(torch.cat([o["data"][key] for o in outs]), value,
                                   rtol=0, atol=0)
        dim = 1 if key != "boundary_frame" else 0
        rebuilt = (torch.cat([o["seq"][key] for o in outs], dim=dim) if dim else
                   outs[0]["seq"][key])
        torch.testing.assert_close(rebuilt, value, rtol=0, atol=0)
        # Microbatch layout: rank r holds row r of each global microbatch.
        want_micro = value.reshape((2, 2) + tuple(value.shape[1:]))
        for r, o in enumerate(outs):
            torch.testing.assert_close(o["micro"][key], want_micro[:, r], rtol=0, atol=0)
    query = torch.cat([o["query"]["query_points"] for o in outs], dim=1)
    torch.testing.assert_close(query, batch["query_points"][:1], rtol=0, atol=0)


def _check_step(name):
    def check(ranks, batch, batch2):
        want = _single_step(batch)
        for out in _ok(ranks, name):
            _assert_step_equal(out, want)
    return check


def _check_grad_accum(ranks, batch, batch2):
    """Held at the gradients, as tests/test_torch_train.py holds accumulation:
    the same terms summed in another order, within 1e-5 of each tensor's
    largest gradient. Parameters after one Adam step would not do: the
    visibility terms' gradients (BCE weight 1e-8) lie below Adam's eps, where
    the update follows their rounding."""
    state, model, _, sched = _state()
    recorder = _Recorder()
    _, metrics = tstep.make_grad_accum_step(model, recorder, sched, num_microbatches=2)(
        state, dict(batch))
    for out in _ok(ranks, "grad_accum"):
        np.testing.assert_allclose(out["loss"], float(metrics["train/loss"]),
                                   rtol=STEP_TOL["loss_rtol"])
        for name, a, b in zip(state.params, out["grads"], recorder.grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * float(b.abs().max()), err_msg=name)


def _check_eval_step(ranks, batch, batch2):
    state, model, _, _ = _state()
    metrics, preds = tstep.make_eval_step(model)(dict(model.state_dict()), batch)
    outs = _ok(ranks, "eval_step")
    for out in outs:
        for k, v in metrics.items():
            np.testing.assert_allclose(out["metrics"][k], float(v), rtol=STEP_TOL["loss_rtol"])
    tracks = torch.cat([o["tracks"] for o in outs], dim=1)  # seq=2: each rank's queries
    np.testing.assert_allclose(tracks.numpy(), preds.tracks.numpy(), atol=2e-4, rtol=0)


def _check_no_new_group(ranks, batch, batch2):
    for out in _ok(ranks, "no_new_group"):
        assert out["after"] == out["before"]


def _check_train_loop(ranks, batch, batch2):
    want = train([batch, batch2], model_type="3dspa", num_epochs=1, learning_rate=LR,
                 warmup_steps=1, num_output_frames=T, log_freq=1, checkpoint_dir=None,
                 max_steps=2, device="cpu", **TINY_3D)
    outs = _ok(ranks, "train_loop")
    for out in outs:
        assert out["step"] == 2 and out["checkpoints"] == ["2"]  # rank 0 wrote it
        _assert_step_equal({"loss": 0.0, **out}, {"loss": 0.0, "params": want.params})


TRAIN_CHECK_FNS = {
    "mesh": _check_mesh, "shard_batch": _check_shard_batch, "step_data": _check_step("step_data"),
    "step_seq": _check_step("step_seq"), "grad_accum": _check_grad_accum,
    "eval_step": _check_eval_step, "no_new_group": _check_no_new_group,
    "train_loop": _check_train_loop,
}


@pytest.mark.parametrize("check", TRAIN_CHECKS)
def test_training_on_two_ranks(train_run, check):
    TRAIN_CHECK_FNS[check](*train_run)


# --------------------------------------------------------------------------
# The serving group's checks
# --------------------------------------------------------------------------

def _jax_tail(config, model, tail_inputs):
    """JAX's fused_tail in ``config`` on the port model's parameters."""
    import jax
    import jax.numpy as jnp

    from tdspa.infer.pipeline import fused_tail as jax_fused_tail
    from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
    from tdspa_torch.infer.convert import params_to_flax

    jmodel = jax_tiny_model_3d(T, use_dino=True, use_depth=True, **TINY_SERVE,
                               **SERVE_CONFIGS[config])
    pred, _, _ = jax_fused_tail(params_to_flax(model.state_dict()),
                                *(jnp.asarray(x.numpy()) for x in tail_inputs),
                                jax.random.PRNGKey(7), jmodel, N_SUPPORT, N_QUERIES, (H, W),
                                True, True)
    return {k: np.asarray(getattr(pred, k), np.float32) for k in ("tracks", "visible_logits")}


def _check_tail(config):
    def check(ranks, tail_inputs, perm, ts, tmp):
        model = _serve_model(config)
        with torch.no_grad():
            pred, batch, tracks_3d = fused_tail(model, *tail_inputs, perm, ts, N_SUPPORT,
                                                N_QUERIES, (H, W))
        jax_pred = _jax_tail(config, model, tail_inputs)
        for out in _ok(ranks, f"tail_{config}"):
            assert "must divide by the mesh's 2 ranks" in out["refused"]
            np.testing.assert_allclose(out["tracks_3d"].numpy(), tracks_3d.numpy(), atol=1e-5)
            assert out["batch"].keys() == batch.keys()
            for k, v in batch.items():
                np.testing.assert_allclose(out["batch"][k].numpy(), v.numpy(), atol=1e-5,
                                           err_msg=k)
            for k in ("tracks", "visible_logits"):
                got, want = out[k].numpy(), getattr(pred, k).numpy()
                np.testing.assert_allclose(got, want, atol=2e-4 if config != "quantize"
                                           else 0.05, err_msg=k)
                if config == "quantize":
                    assert np.mean(np.abs(got - want) < 1e-6) > 0.99
                rel = np.abs(got - jax_pred[k]).max() / np.abs(jax_pred[k]).max()
                assert rel < (0.03 if k == "tracks" else 0.05), (k, rel)
    return check


def _check_export_roundtrip(ranks, tail_inputs, perm, ts, tmp):
    for out in _ok(ranks, "export_roundtrip"):
        assert out["nr_devices"] == out["manifest"]["nr_devices"] == WORLD
        assert out["got"].keys() == out["live"].keys()
        for k, v in out["live"].items():
            assert torch.equal(out["got"][k], v), k
    # The artifact is tied to its world size: a process group of one rank
    # refuses it.
    loaded = export.load_exported_mesh(os.path.join(tmp, "mesh_tail.pt2"))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                            rank=0, world_size=1)
    try:
        model = _serve_model("default")
        with pytest.raises(ValueError, match="exported for 2 ranks"):
            export.call_exported_mesh(loaded, make_mesh(), export.serving_params(model),
                                      perm, ts, *tail_inputs)
    finally:
        dist.destroy_process_group()


SERVE_CHECK_FNS = {**{f"tail_{c}": _check_tail(c) for c in SERVE_CONFIGS},
                   "export_roundtrip": _check_export_roundtrip}


@pytest.mark.parametrize("check", SERVE_CHECKS)
def test_serving_on_two_ranks(serve_run, check):
    SERVE_CHECK_FNS[check](*serve_run)


def test_a_mesh_needs_a_process_group():
    """No fallback: without an initialised process group a mesh raises."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    assert mesh_lib.maybe_initialize_distributed(device="cpu") is False


def test_the_encoder_chunk_must_divide_each_ranks_support_tracks():
    """Under ``seq`` each rank encodes its share of the support tracks in
    ``encoder_scan_chunk_size`` chunks; a chunk that does not divide that
    share raises before any collective."""
    from tdspa_torch.parallel.shardings import model_kwargs

    model = tiny_model_3d(T, device="cpu", encoder_scan_chunk_size=3)
    local = {"support_tracks": torch.zeros(1, 4, T, 3)}  # 8 support tracks over seq=2
    with pytest.raises(ValueError, match="encoder_scan_chunk_size=3 must divide each rank's 4"):
        model_kwargs(None, model, local)
