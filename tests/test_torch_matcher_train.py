"""The matcher's training half in tdspa_torch against tdspa's: the training
scenes, the flax parameter layout both ways, the ``.npz`` files across the
two packages, and ``train_matcher`` step for step from JAX's initialisation
with the noise JAX's loop draws, at the tiny configuration of JAX's own
``tests/unit/test_matcher.py::test_training_descends``.

Tolerances: the first 5 logged losses at 1e-5 relative (f32 summation order
only: the same parameters and inputs). Over the 60 steps rounding-level
gradient differences grow, since Adam divides each gradient by its own
running RMS: all 60 losses within 1e-4 relative and the final parameters
within 1e-4 absolute (measured on this configuration: 3.4e-6 and 4.9e-7).
"""

import jax
import numpy as np
import pytest
import torch

from tdspa.features import matcher as jax_matcher
from tdspa_torch.features import matcher

STEPS, LR = 60, 2e-3
CONFIG = dict(dim=8, radius=2, hidden=32)
SCENES = dict(num_frames=8, height=64, width=96, grid_size=6)
NUM_SCENES = 4
FIRST_RTOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny training runs on one torch thread: beside other test workers
    on the host, torch's intra-op threads oversubscribe the cores and the
    convolutions' backward slows down about 30 times (the 60-step run: 82.5 s
    on 8 threads against 2.6 s on one, on an 8-core host kept busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's 60 logged steps and final parameters (one run for the module)."""
    params, log = jax_matcher.train_matcher(
        jax.random.PRNGKey(0), steps=STEPS, num_scenes=NUM_SCENES, log_every=1,
        scene_kwargs=SCENES, **CONFIG)
    return params, log


@pytest.fixture(scope="module")
def port_run():
    """The port's steps from JAX's initialisation, with the perturbations JAX's
    loop draws (``key, sk = split(key)``, then ``uniform(sk, ...)``)."""
    key = jax.random.PRNGKey(0)
    model = matcher.matcher_params_from_flax(jax_matcher.init_matcher(key, **CONFIG))
    videos, tracks, visible = matcher.make_training_scenes(NUM_SCENES, **SCENES)
    videos, tracks = torch.from_numpy(videos), torch.from_numpy(tracks)
    visible = torch.from_numpy(visible.astype(np.float32))
    optimizer = matcher.matcher_optimizer(LR, STEPS)
    state = optimizer.init(dict(model.named_parameters()))
    reach = float(CONFIG["radius"] * 2)
    log = []
    for i in range(STEPS):
        key, sk = jax.random.split(key)
        s = i % NUM_SCENES
        noise = np.array(jax.random.uniform(sk, tracks[s].shape, minval=-reach, maxval=reach))
        state, losses = matcher.matcher_train_step(
            model, optimizer, state, videos[s], tracks[s], visible[s], torch.from_numpy(noise))
        log.append((i, *(float(x) for x in losses)))
    return model, log


# 0.5 is the CLI's default (the unshipped v2 recipe); 0 is the round-4 stream
# of the shipped asset, which draws one number fewer per scene.
@pytest.mark.parametrize("natural_frac,num_frames", [(0.5, 6), (0.0, 24)])
def test_training_scenes_equal_jax_with_every_augmentation(natural_frac, num_frames):
    kw = dict(num_frames=num_frames, height=64, width=96, grid_size=4, deform_amp_max=5.0,
              rot_rate_max=float(np.deg2rad(2.5)), natural_frac=natural_frac)
    want = jax_matcher.make_training_scenes(6, seed=3, **kw)
    got = matcher.make_training_scenes(6, seed=3, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bank", [0, 2])
def test_flax_layout_round_trips_and_npz_files_cross_packages(bank, tmp_path):
    tree = jax_matcher.init_matcher(jax.random.PRNGKey(1), bank=bank, **CONFIG)
    model = matcher.matcher_params_from_flax(tree)
    back = _leaves(matcher.matcher_params_to_flax(model))
    want = _leaves(tree)
    assert back.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)

    # Each file, read by either package, gives that package's refinement with
    # the original parameters exactly: the files hold the same values.
    video = np.random.default_rng(0).integers(0, 255, (4, 32, 48, 3), dtype=np.uint8)
    tracks = np.random.default_rng(1).uniform(4, 28, (5, 4, 2)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    matcher.save_matcher(ours, model)
    jax_matcher.save_matcher(theirs, tree)
    want_jax = jax_matcher.refine_tracks(tree, video, tracks)
    want_port = matcher.refine_tracks(model, torch.from_numpy(video), torch.from_numpy(tracks))
    for path in (ours, theirs):
        got_jax = jax_matcher.refine_tracks(jax_matcher.load_matcher(path), video, tracks)
        got_port = matcher.refine_tracks(
            matcher.matcher_params_from_flax(matcher.load_matcher(path)),
            torch.from_numpy(video), torch.from_numpy(tracks))
        for got, want in zip((*got_jax, *got_port), (*want_jax, *want_port)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_init_matcher_has_flax_layout_and_laws():
    """JAX's tree layout; zero biases; LeCun-normal kernels: truncated at two
    standard deviations of sqrt(1 / fan_in) / 0.8796, and of that standard
    deviation where a kernel has enough values to tell (within 10 %)."""
    model = matcher.init_matcher(bank=2, generator=torch.Generator().manual_seed(0), device="cpu",
                                 **CONFIG)
    want = _leaves(jax_matcher.init_matcher(jax.random.PRNGKey(1), bank=2, **CONFIG))
    got = _leaves(matcher.matcher_params_to_flax(model))
    assert {k: (v.shape, v.dtype) for k, v in got.items() if not k.startswith("config")} == \
        {k: (v.shape, v.dtype) for k, v in want.items() if not k.startswith("config")}
    for name, value in got.items():
        if name.startswith("config"):
            assert int(value) == int(want[name]), name
        elif name.endswith("bias"):
            assert not value.any(), name
        else:
            std = np.sqrt(1.0 / np.prod(value.shape[:-1]))
            assert np.abs(value).max() <= 2 * std / 0.87962566, name
            if value.size >= 1000:
                assert abs(value.std() / std - 1.0) < 0.1, name


def test_train_steps_match_jax(jax_run, port_run):
    (want_params, want_log), (model, got_log) = jax_run, port_run
    want = np.asarray([row[1:] for row in want_log])
    got = np.asarray([row[1:] for row in got_log])
    assert [row[0] for row in want_log] == [row[0] for row in got_log] == list(range(STEPS))
    np.testing.assert_allclose(got[:5], want[:5], rtol=FIRST_RTOL, atol=0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    got_params = _leaves(matcher.matcher_params_to_flax(model))
    for name, value in _leaves(want_params).items():
        if not name.startswith("config"):
            np.testing.assert_allclose(got_params[name], value, rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)


def test_port_training_descends():
    """The port's own run (its init and its noise) passes JAX's check."""
    model, log = matcher.train_matcher(
        torch.Generator().manual_seed(0), steps=STEPS, num_scenes=NUM_SCENES, log_every=59,
        scene_kwargs=SCENES, device="cpu", **CONFIG)
    assert [row[0] for row in log] == [0, 59]
    assert log[-1][1] < log[0][1] * 0.6, log


def test_training_reaches_the_feature_net():
    """Gradients flow into the feature net through the template vector and
    the cost patches (the plain, differentiable route)."""
    model = matcher.init_matcher(bank=2, generator=torch.Generator().manual_seed(0),
                                 device="cpu", **CONFIG)
    videos, tracks, visible = matcher.make_training_scenes(1, **SCENES)
    loss, _, _ = matcher.matcher_loss(model, torch.from_numpy(videos[0]),
                                      torch.from_numpy(tracks[0]),
                                      torch.from_numpy(visible[0].astype(np.float32)),
                                      torch.zeros(tracks[0].shape))
    loss.backward()
    for name, param in model.named_parameters():
        assert param.grad is not None and param.grad.abs().max() > 0, name


def test_cpu_wrappers_stay_differentiable():
    """On CPU tensors that autograd records, the kernel wrappers run their
    plain versions, whose gradients flow (the custom ops have no autograd
    formula); without autograd they go through the ``tdspa::`` ops, with the
    same values."""
    from tdspa_torch.kernels.bilinear import bilinear_sample, bilinear_sample_reference
    from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((3, 10, 12, 8)).astype(np.float32))
    tvecs = torch.from_numpy(rng.standard_normal((5, 2, 8)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(0, 9, (5, 3, 2)).astype(np.float32))
    for fn, ref, args in ((bilinear_sample, bilinear_sample_reference, (feats, pos)),
                          (cost_patches_multi, cost_patches_reference, (feats, tvecs, pos))):
        leaf = args[0].clone().requires_grad_()
        out = fn(leaf, *args[1:])
        (grad,) = torch.autograd.grad(out.square().sum(), leaf)
        assert grad.abs().max() > 0
        with torch.no_grad():
            torch.testing.assert_close(fn(*args), ref(*args), rtol=0, atol=0)
    # The op itself has no autograd formula: a backward through it raises.
    from tdspa_torch.kernels import ops

    out = ops.bilinear_sample(feats.clone().requires_grad_(), pos, torch.float32)
    with pytest.raises(RuntimeError):
        out.sum().backward()
