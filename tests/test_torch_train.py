"""tdspa_torch.train, .data and the train CLI against tdspa.train / tdspa.data
on the CPU, at tiny sizes with flax parameters carried over.

Tolerances: losses, gradients and f32 forwards at 2e-5 (summation order
only). Parameters after optimizer updates from the two frameworks' own
gradients: an absolute 2 x lr x steps, because Adam divides each gradient by
its own running RMS, so an element whose gradient is rounding noise moves by
up to the learning rate either way; from identical gradients the update is
the same arithmetic, held at 1e-6 relative. Gradient accumulation against
the full step at JAX's 2e-6.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.data import batch_prep as jbatch_prep
from tdspa.data import providers as jproviders
from tdspa.infer.checkpoint import load_checkpoint as jax_load_checkpoint
from tdspa.infer.checkpoint import save_checkpoint_npz as jax_save_checkpoint_npz
from tdspa.train import losses as jlosses
from tdspa.train import state as jstate
from tdspa.train import step as jstep
from tdspa.train.schedule import create_learning_rate_schedule as jax_schedule
from tdspa.utils.testing import synthetic_batch as jax_synthetic_batch
from tdspa_torch.cli import train as train_cli
from tdspa_torch.data import batch_prep, providers
from tdspa_torch.data.prefetch import device_prefetch
from tdspa_torch.infer.checkpoint import (
    TrainCheckpointer,
    load_checkpoint,
    save_checkpoint_npz,
)
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.models import trajan2d
from tdspa_torch.models.containers import TrackAutoEncoderResults
from tdspa_torch.train import losses, step as tstep
from tdspa_torch.train.loop import train
from tdspa_torch.train.metrics import MetricLogger
from tdspa_torch.train.schedule import create_learning_rate_schedule
from tdspa_torch.train.state import Optimizer, create_model_state
from tdspa_torch.utils import jax_prng
from tdspa_torch.utils.testing import TINY_3D, synthetic_batch, to_torch

T = 10
LR = 1e-3
TOL = dict(rtol=2e-5, atol=2e-5)


def _batch(model_type, batch=2, seed=0):
    coords = 3 if model_type == "3dspa" else 2
    return synthetic_batch(seed, batch=batch, num_support=8, num_queries=4, num_frames=T,
                           num_coords=coords)


def _states(model_type, warmup_steps=0):
    """JAX's (state, model, tx, schedule) and the port's, both holding the
    port's seeded tiny parameters."""
    port = create_model_state(0, model_type=model_type, learning_rate=LR,
                              warmup_steps=warmup_steps, total_steps=100, num_output_frames=T,
                              use_dino=False, use_depth=False, device="cpu", **TINY_3D)
    # Copies: numpy views of the port's tensors would alias JAX's buffers, and
    # the port's in-place updates would reach JAX's (asynchronous) step.
    params = jax.tree_util.tree_map(jnp.array, params_to_flax(port[1].state_dict()))
    tx, schedule = jstate.create_optimizer(LR, warmup_steps, 100)
    jmodel = jstate.build_model(model_type, num_output_frames=T, use_dino=False,
                                use_depth=False, **TINY_3D)
    jst = jstate.TrainState(params=params, opt_state=tx.init(params), step=0, rng=None)
    return (jst, jmodel, tx, schedule), port


def _assert_tree(got: dict, want_tree, **tol):
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), **tol,
                                   err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    tracks = rng.normal(size=(2, 5, T, 3)).astype(np.float32)
    logits = (3 * rng.normal(size=(2, 5, T, 1))).astype(np.float32)
    targets = {"query_tracks": rng.normal(size=(2, 5, T, 3)).astype(np.float32),
               "query_tracks_visible": (rng.uniform(size=(2, 5, T, 1)) > 0.4).astype(np.float32)}
    for jfn, tfn in ((jlosses.compute_loss_3d, losses.compute_loss_3d),
                     (jlosses.compute_loss_2d, losses.compute_loss_2d)):
        class Preds:
            pass

        jp = Preds()
        jp.tracks, jp.visible_logits = jnp.asarray(tracks), jnp.asarray(logits)
        want = jfn(jp, {k: jnp.asarray(v) for k, v in targets.items()})
        got = tfn(TrackAutoEncoderResults(torch.from_numpy(tracks), torch.from_numpy(logits),
                                          torch.zeros(1)), to_torch(targets))
        for key in ("total_loss", "position_loss", "visible_loss"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=2e-6, err_msg=key)
    # No visible point: the mass clamps to 1 and BCE still counts every entry.
    targets["query_tracks_visible"][:] = 0.0
    got = losses.compute_loss_3d(TrackAutoEncoderResults(
        torch.from_numpy(tracks), torch.from_numpy(logits), torch.zeros(1)), to_torch(targets))
    assert float(got["position_loss"]) == 0.0 and float(got["visible_loss"]) > 0.0


@pytest.mark.parametrize("base_lr,warmup,total", [(1e-3, 10, 110), (1e-4, 0, 50), (2e-4, 5, 3)])
def test_schedule_matches_optax(base_lr, warmup, total):
    """optax computes in f32 (its cosine too), the port in f64 rounded to f32:
    equal within an f32 rounding of the base rate."""
    want = jax_schedule(base_lr, warmup, total)
    got = create_learning_rate_schedule(base_lr, warmup, total)
    for step in list(range(0, 2 * max(total, warmup) + 3)):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-7 * base_lr)
    assert got(0) == (0.0 if warmup else float(np.float32(base_lr)))


def test_optimizer_matches_optax_from_the_same_gradients():
    """Three updates from the same gradients: one below the clip norm, one
    far above it (clipped), one with an exactly zero tensor."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx, schedule = jstate.create_optimizer(LR, warmup_steps=1, total_steps=10)
    opt_state = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    optimizer = Optimizer(create_learning_rate_schedule(LR, 1, 10))
    state = optimizer.init(tparams)
    for scale in (1e-2, 50.0, 1.0):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        if scale == 1.0:
            grads["b"][:] = 0.0
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        state = optimizer.update([torch.from_numpy(grads[k]) for k in tparams], state, tparams)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert state.count == 3
    for k in shapes:
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(opt_state[1][0].mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(opt_state[1][0].nu[k]),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("model_type", ["3dspa", "trajan"])
def test_train_step_matches_jax(model_type):
    """Two steps of ``make_train_step`` from the same parameters and batch:
    the metrics of each at 2e-5; the clipped gradients of the first (its
    first moment, 0.1 x clip(g), before any update) at 2e-5; the parameters
    after each at 2 x lr x steps; for 3DSPA also the eval step's metrics
    after them."""
    batch = _batch(model_type)
    (jst, jmodel, tx, jsched), (st, model, optimizer, sched) = _states(model_type)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = to_torch(batch)
    jax_train = jstep.make_train_step(jmodel, tx, jsched, donate=False)
    port_train = tstep.make_train_step(model, optimizer, sched)
    for step in range(2):
        jst, jm = jax_train(jst, jbatch)
        st, m = port_train(st, tbatch)
        for key in jm:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-5, atol=1e-12,
                                       err_msg=key)
        if step == 0:
            mu = params_from_flax(jax.tree_util.tree_map(np.asarray, jst.opt_state[1][0].mu))
            for name, value in st.opt_state.mu.items():
                np.testing.assert_allclose(value.numpy(), mu[name].numpy(), rtol=2e-5,
                                           atol=2e-5 * float(mu[name].abs().max()),
                                           err_msg=name)
        _assert_tree(st.params, jst.params, rtol=0, atol=2 * LR * (step + 1))
    assert st.step == int(jst.step) == 2 and st.opt_state.count == 2
    metrics, _ = tstep.make_eval_step(model)(st.params, tbatch)
    assert sorted(metrics) == ["eval/loss", "eval/position_loss", "eval/visible_loss"]
    if model_type == "3dspa":
        jmetrics, _ = jstep.make_eval_step(jmodel)(jst.params, jbatch)
        for key in metrics:
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-3,
                                       err_msg=key)


class _Recorder:
    """An optimizer that records the gradients it is given."""

    def __init__(self):
        self.grads = []

    def update(self, grads, state, params):
        self.grads.append([g.clone() for g in grads])
        return state


@pytest.fixture(scope="module")
def jax_accum_steps():
    """JAX's full and accumulated (2 microbatches) steps of the tiny 3DSPA,
    compiled once for the batch of 4 the accumulation tests use."""
    (_, jmodel, tx, jsched), _ = _states("3dspa", warmup_steps=1)
    return (jstep.make_train_step(jmodel, tx, jsched, donate=False),
            jstep.make_grad_accum_step(jmodel, tx, jsched, num_microbatches=2, donate=False))


@pytest.mark.parametrize("occluded", [False, True])
def test_grad_accum_equals_the_full_step(occluded, jax_accum_steps, monkeypatch):
    """The full and the accumulated step (2 microbatches) give JAX's losses
    at 2e-5: each microbatch draws the bottleneck's fixed dither for its own
    shape, in both frameworks, so the two steps' losses differ by that noise
    alone. The parameters after that first (lr 0) update agree at 2e-6, as in
    JAX's test. Then, with the dither made the same for every example, the
    accumulated gradients (each microbatch's weighted by its clamped visible
    mass, divided by the true total mass) equal the full batch's at 2e-6,
    also when the second microbatch sees no visible point (its BCE term
    still counts)."""
    batch = _batch("3dspa", batch=4, seed=3)
    if occluded:
        batch["query_tracks_visible"][2:] = 0.0
    tbatch = to_torch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def steps(optimizer_of):
        out = []
        for make in (tstep.make_train_step, functools.partial(tstep.make_grad_accum_step,
                                                              num_microbatches=2)):
            (jst, _, _, _), (st, model, optimizer, sched) = _states("3dspa", warmup_steps=1)
            st, metrics = make(model, optimizer_of(optimizer), sched)(st, tbatch)
            out.append((metrics, {k: v.detach().clone() for k, v in st.params.items()}, jst))
        return out

    (full, full_params, jst), (acc, acc_params, _) = steps(lambda optimizer: optimizer)
    for (metrics, _, _), jax_step in zip(((full, None, None), (acc, None, None)),
                                         jax_accum_steps):
        _, jmetrics = jax_step(jst, jbatch)
        np.testing.assert_allclose(float(metrics["train/loss"]), float(jmetrics["train/loss"]),
                                   rtol=2e-5)
    for k in full_params:
        np.testing.assert_allclose(acc_params[k].numpy(), full_params[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)

    def per_example_dither(shape, device):
        return torch.from_numpy(jax_prng.uniform(shape[1:])).expand(shape)

    monkeypatch.setattr(trajan2d, "_dither", per_example_dither)
    recorder = _Recorder()
    (full, _, _), (acc, _, _) = steps(lambda optimizer: recorder)
    np.testing.assert_allclose(float(acc["train/loss"]), float(full["train/loss"]), rtol=2e-6)
    # The same per-example terms summed in another order, scaled by the
    # microbatch mass and back: f32 roundings of terms that partly cancel,
    # within 1e-5 of each tensor's largest gradient.
    for name, a, b in zip(full_params, *recorder.grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()), err_msg=name)
    (_, _, _, _), (st, model, _, sched) = _states("3dspa")
    with pytest.raises(ValueError, match="multiple of num_microbatches"):
        tstep.make_grad_accum_step(model, recorder, sched, num_microbatches=3)(st, tbatch)


def test_a_mesh_raises():
    """No fallback: a mesh needs an initialised process group (the sharded
    steps and loop run in tests/test_torch_parallel.py)."""
    from tdspa_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(ValueError, match="process group has not been initialized"):
        train([_batch("3dspa")], mesh=object(), device="cpu")


@pytest.mark.parametrize("with_features", [False, True])
def test_batch_prep_and_synthetic_provider_equal_jax(with_features):
    for coords in (2, 3):
        kwargs = dict(num_videos=3, num_tracks=16, num_frames=7, num_coords=coords,
                      with_features=with_features and coords == 3, seed=2)
        want_ex, got_ex = jproviders.SyntheticTrackProvider(**kwargs)[1], \
            providers.SyntheticTrackProvider(**kwargs)[1]
        assert sorted(got_ex) == sorted(want_ex)
        for k in want_ex:
            np.testing.assert_array_equal(got_ex[k], want_ex[k], err_msg=k)
        if coords == 3:
            want = jbatch_prep.prepare_3d_batch(want_ex, 6, 5, 9, seed=4)
            got = batch_prep.prepare_3d_batch(got_ex, 6, 5, 9, seed=4)
        else:
            want = jbatch_prep.prepare_2d_batch(want_ex, 6, 5, 9, seed=4)
            got = batch_prep.prepare_2d_batch(got_ex, 6, 5, 9, seed=4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_batched_dataset_and_loaders_equal_jax(tmp_path):
    """Two shuffled passes of the synthetic fallback and a pass over an npz
    directory give JAX's batches; a name that is not a directory needs tfds."""
    kw = dict(batch_size=2, num_support_tracks=8, num_query_tracks=8, num_frames=6)
    for jload, load in ((jproviders.load_kubric3d_dataset, providers.load_kubric3d_dataset),
                        (jproviders.load_tapvid_dataset, providers.load_tapvid_dataset)):
        want_ds, got_ds = jload("", **kw), load("", **kw)
        assert len(got_ds) == len(want_ds) == 64
        for _ in range(2):
            for want, got in zip(list(want_ds.take(2)), list(got_ds.take(2))):
                for k in want:
                    np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    example = providers.SyntheticTrackProvider(num_tracks=10, num_frames=6)[0]
    np.savez(tmp_path / "a.npz", **example)
    np.savez(tmp_path / "b.npz", **example)
    got = list(providers.load_kubric3d_dataset(str(tmp_path), use_dino=False, **kw))
    want = list(jproviders.load_kubric3d_dataset(str(tmp_path), use_dino=False, **kw))
    assert len(got) == len(want) == 1
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], np.asarray(want[0][k]), err_msg=k)
    assert len(providers.load_tapvid3d_dataset(str(tmp_path))) == 2
    with pytest.raises(ImportError, match="tfds dataset name"):
        providers.load_tapvid_dataset("no_such_dataset_name", **kw)


def test_device_prefetch_keeps_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32), "n": np.array([i], np.int32)}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), buffer_size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["n"].dtype == torch.int32
        assert float(b["x"][0, 0]) == i


def test_checkpoints_cross_to_jax_and_back(tmp_path):
    """``save_checkpoint_npz`` writes what JAX's ``load_checkpoint`` reads; a
    ``TrainCheckpointer`` step directory loads through ``load_checkpoint``;
    the checkpointer keeps the newest three steps."""
    st, model, _, _ = create_model_state(0, model_type="trajan", num_output_frames=T,
                                         device="cpu", **TINY_3D)
    save_checkpoint_npz(str(tmp_path / "p.npz"), model.state_dict())
    tree = jax_load_checkpoint(str(tmp_path / "p.npz"))
    _assert_tree(dict(model.state_dict()), tree, rtol=0, atol=0)
    jax_save_checkpoint_npz(str(tmp_path / "j.npz"), params_to_flax(model.state_dict()))
    for path in ("p.npz", "j.npz"):
        loaded = load_checkpoint(str(tmp_path / path), device="cpu")
        assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    for step in range(1, 6):
        ckpt.save(step, {"params": {k: v * step for k, v in model.state_dict().items()},
                         "step": step})
    assert ckpt.latest_step() == 5 and sorted(int(p.name) for p in (tmp_path / "ck").iterdir()) \
        == [3, 4, 5]
    loaded = load_checkpoint(str(tmp_path / "ck" / "4"), device="cpu")
    assert all(torch.equal(loaded[k], 4 * v) for k, v in model.state_dict().items())
    with pytest.raises(NotImplementedError, match="TrainCheckpointer step directory"):
        load_checkpoint(str(tmp_path / "ck"), device="cpu")


def test_save_resume_and_continue_equals_an_uninterrupted_run(tmp_path):
    """3 steps in one run, or 2 steps, a checkpoint and a resumed third step:
    the same parameters and optimizer state (the data is one batch repeated,
    since a resumed run restarts its epoch)."""
    batch = _batch("3dspa")
    kw = dict(model_type="3dspa", num_epochs=5, learning_rate=LR, warmup_steps=1,
              num_output_frames=T, use_dino=False, use_depth=False, log_freq=1, device="cpu",
              **TINY_3D)
    whole = train([batch] * 3, checkpoint_dir=None, max_steps=3, **kw)
    log = MetricLogger(use_wandb=False)
    first = train([batch] * 3, checkpoint_dir=str(tmp_path), save_freq=2, max_steps=2,
                  logger=log, **kw)
    assert first.step == 2 and [r["step"] for r in log.history] == [1, 2]
    resumed = train([batch] * 3, checkpoint_dir=str(tmp_path), save_freq=2, max_steps=3, **kw)
    assert resumed.step == whole.step == 3 and resumed.opt_state.count == 3
    for k in whole.params:
        torch.testing.assert_close(resumed.params[k], whole.params[k], rtol=0, atol=1e-7)
        torch.testing.assert_close(resumed.opt_state.nu[k], whole.opt_state.nu[k], rtol=1e-6,
                                   atol=0)


def test_train_cli_tiny_on_the_cpu(tmp_path, monkeypatch):
    """``--tiny_model --max_steps=2 --device=cpu`` on the synthetic fallback:
    JAX's JSONL keys, an eval record and a checkpoint that loads into a model
    whose eval loss is the logged one."""
    monkeypatch.chdir(tmp_path)
    jsonl = tmp_path / "m.jsonl"
    state = train_cli.main([
        "--model_type=trajan", "--tiny_model", "--max_steps=2", "--batch_size=2",
        "--nouse_wandb", "--num_output_frames=8", "--log_freq=1", "--save_freq=2",
        "--eval_freq=2", "--warmup_steps=0", f"--checkpoint_dir={tmp_path}/ck",
        f"--log_jsonl={jsonl}", "--device=cpu"])
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [sorted(r) for r in records] == [
        sorted(["train/loss", "train/position_loss", "train/visible_loss",
                "train/learning_rate", "step", "wall_s"])] * 2 + [
        sorted(["eval/loss", "eval/position_loss", "eval/visible_loss", "step", "wall_s"])]
    assert state.step == 2
    loaded = load_checkpoint(str(tmp_path / "ck" / "2"), device="cpu")
    assert all(torch.equal(loaded[k], v) for k, v in state.params.items())
    # --debug_nans wraps the run in the NaN check: a NaN in the data raises
    # at the first operator that makes one (tests/test_torch_debug.py).
    monkeypatch.setattr(providers.SyntheticTrackProvider, "__getitem__",
                        _nan_example(providers.SyntheticTrackProvider.__getitem__))
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        train_cli.main(["--model_type=trajan", "--tiny_model", "--max_steps=1",
                        "--batch_size=2", "--nouse_wandb", "--num_output_frames=8",
                        "--checkpoint_dir=", "--debug_nans", "--device=cpu"])


def _nan_example(getitem):
    def with_nan(self, i):
        example = getitem(self, i)
        example["tracks"] = example["tracks"].copy()
        example["tracks"][0, 0, 0] = np.nan
        return example
    return with_nan


def test_metric_logger_writes_jax_records(tmp_path):
    path = tmp_path / "log" / "m.jsonl"
    log = MetricLogger(project="p", use_wandb=False, jsonl_path=str(path))
    log.log({"train/loss": torch.tensor(2.5), "train/learning_rate": 0.1}, step=3)
    record = json.loads(path.read_text())
    assert record["train/loss"] == 2.5 and record["step"] == 3 and "wall_s" in record
    assert log.history == [record]


def test_gpu_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train([_batch("3dspa")], checkpoint_dir=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(device_prefetch([{"x": np.zeros(1)}]))
