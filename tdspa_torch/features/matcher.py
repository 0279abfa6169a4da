"""Learned matching head over frame-0 cost volumes (port of
``tdspa/features/matcher.py``: the runtime and the training).

* ``MatcherFeatureNet``: grayscale -> L2-normalised stride-2 feature maps
  (7x7 conv, tanh GELU, 3x3 conv), in the JAX layout ``[T Hf Wf D]``.
* ``MatcherHead``: an MLP over the (2R+1)^2 cost patch (plus its
  soft-argmax, peak and mean) -> a sub-pixel offset and a visibility logit.
* ``TemplateSelect`` + the template bank: phase 2 re-refines against a
  learned softmax over the costs of visibility-gated historical templates.
* ``refine_tracks``: the iterative runtime pass with the motion-field rescue
  round; its cost patches go through ``tdspa_torch.kernels.matcher``
  (``csrc/matcher.cu`` on CUDA tensors, ``cost_patches_reference`` on CPU
  tensors).
* ``estimate_degradation``: the photometric statistics of the tracker's
  ``auto`` policy.
* ``train_matcher``: JAX's training on synthetic degraded scenes
  (``make_training_scenes``), one scene per step, every unrolled iteration
  supervised, optax's AdamW written out (``matcher_train_step``). It runs
  the refinement through the plain, differentiable cost patches and samples
  (JAX's XLA path); the kernels are forward-only. ``python -m
  tdspa_torch.features.matcher out.npz`` runs the shipped recipe.

Weights are the flax tree of ``tdspa/features/matcher.py``
(``load_matcher``), mapped to the modules by ``matcher_params_from_flax`` and
back by ``matcher_params_to_flax``; ``save_matcher`` writes JAX's flat
``.npz``. ``load_matcher("default")`` reads this package's copy of the
shipped weights, ``tdspa_torch/assets/matcher_default.npz``.

Numerics kept from the JAX package: flax's ``nn.gelu`` is the tanh form;
XLA's SAME padding of the stride-2 7x7 conv pads (2, 3) on an even side;
``jnp.median`` averages the two middle values (``torch.quantile(x, 0.5)``,
not ``torch.median``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdspa_torch.core.attention import lecun_normal_
from tdspa_torch.kernels.bilinear import bilinear_sample_reference
from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference, offset_grid
from tdspa_torch.ops.geometry import bilinear_sample
from tdspa_torch.train.schedule import warmup_cosine_decay_schedule
from tdspa_torch.train.state import OptState, Optimizer
from tdspa_torch.utils.device import resolve_device

# Motion-field rescue operating point (tdspa/features/matcher.py).
RESCUE_GATE = 0.0
RESCUE_MARGIN = 1.0
RESCUE_PENALTY = 2.5
RESCUE_CONF = 1.0
RESCUE_SOFTEN = 25.0

# Auto-engagement thresholds of the tracker's 'auto' policy
# (tdspa/features/matcher.py: calibrated on the synthetic scene family).
AUTO_NOISE_SIGMA = 12.0
AUTO_MIN_CONTRAST = 45.0
AUTO_FLICKER = 0.05
AUTO_LK_OCCLUDED_FRAC = 0.45


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MatcherFeatureNet(nn.Module):
    """Grayscale [T H W] (0..1) -> L2-normalised features [T H/s W/s dim]."""

    def __init__(self, dim: int = 16, hidden: int = 16, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv0 = nn.Conv2d(1, hidden, 7, stride=stride)
        self.conv1 = nn.Conv2d(hidden, dim, 3)

    def forward(self, gray):
        x = (gray * 2.0 - 1.0)[:, None]  # [T 1 H W]
        (t0, b0), (l0, r0) = (_same_pad(gray.shape[1], 7, self.stride),
                              _same_pad(gray.shape[2], 7, self.stride))
        x = F.gelu(self.conv0(F.pad(x, (l0, r0, t0, b0))), approximate="tanh")
        x = self.conv1(F.pad(x, (1, 1, 1, 1)))
        x = x.permute(0, 2, 3, 1)  # the JAX layout [T Hf Wf D]
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def img_to_feat(coords, stride: int):
    """Image-pixel (x, y) -> feature-map coordinates (output i sits at input
    stride*i + stride-1)."""
    return (coords - float(stride - 1)) / float(stride)


class MatcherHead(nn.Module):
    """Cost patch [(2R+1)^2] (+ peak stats) -> (offset [2], vis logit)."""

    def __init__(self, radius: int = 4, hidden: int = 128):
        super().__init__()
        self.radius = radius
        k2 = (2 * radius + 1) ** 2
        self.fc0 = nn.Linear(k2 + 4, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc_out = nn.Linear(hidden, 3)

    def forward(self, cost):  # [... K2]
        offs = offset_grid(self.radius, cost.device)  # [K2 2]
        w = torch.softmax(cost * 10.0, dim=-1)
        soft_xy = w @ offs
        peak = torch.amax(cost, dim=-1, keepdim=True)
        mean = torch.mean(cost, dim=-1, keepdim=True)
        x = torch.cat([cost, soft_xy, peak, mean], dim=-1)
        x = F.gelu(self.fc0(x), approximate="tanh")
        x = F.gelu(self.fc1(x), approximate="tanh")
        out = self.fc_out(x)
        return soft_xy + torch.tanh(out[..., :2]) * self.radius, out[..., 2]


class TemplateSelect(nn.Module):
    """Per-template stats [... M 4] -> softmax selection weights [... M]."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 1)

    def forward(self, stats):
        return torch.softmax(self.fc(stats)[..., 0], dim=-1)


class Matcher(nn.Module):
    """The matcher's modules and configuration (one flax tree)."""

    def __init__(self, dim=16, radius=4, hidden=128, stride=2, fhidden=16, bank=0):
        super().__init__()
        self.dim, self.radius, self.hidden = dim, radius, hidden
        self.stride, self.fhidden, self.bank = stride, fhidden, bank
        self.feature = MatcherFeatureNet(dim=dim, hidden=fhidden, stride=stride)
        self.head = MatcherHead(radius=radius, hidden=hidden)
        self.select = TemplateSelect() if bank > 0 else None


def _cfg(config: dict) -> dict:
    def geti(name, default=None):
        return int(np.asarray(config[name])) if name in config else default

    return dict(dim=geti("dim"), radius=geti("radius"), hidden=geti("hidden"),
                stride=geti("stride", 1), fhidden=geti("fhidden", 16), bank=geti("bank", 0))


def matcher_params_from_flax(tree, device="cpu") -> Matcher:
    """A ``Matcher`` on ``device`` from a ``load_matcher``-style flax tree of
    arrays: conv kernels [kh,kw,in,out] -> [out,in,kh,kw], dense kernels
    [in,out] -> Linear.weight [out,in], ``config/*`` scalars -> the module
    configuration."""
    model = Matcher(**_cfg(tree["config"]))

    def arr(x):
        return torch.from_numpy(np.array(x, np.float32))

    state = {}
    for name in ("conv0", "conv1"):
        state[f"feature.{name}.weight"] = arr(tree["feature"][name]["kernel"]).permute(3, 2, 0, 1)
        state[f"feature.{name}.bias"] = arr(tree["feature"][name]["bias"])
    for name in ("fc0", "fc1", "fc_out"):
        state[f"head.{name}.weight"] = arr(tree["head"][name]["kernel"]).T
        state[f"head.{name}.bias"] = arr(tree["head"][name]["bias"])
    if model.select is not None:
        state["select.fc.weight"] = arr(tree["select"]["fc"]["kernel"]).T
        state["select.fc.bias"] = arr(tree["select"]["fc"]["bias"])
    model.load_state_dict({k: v.contiguous() for k, v in state.items()})
    return model.to(device).eval()


def init_matcher(dim: int = 16, radius: int = 4, hidden: int = 128, stride: int = 2,
                 fhidden: int = 32, bank: int = 0, generator: torch.Generator | None = None,
                 device="cuda") -> Matcher:
    """A new ``Matcher`` on ``device`` with flax's initialisers' laws (LeCun
    normal kernels, zero biases), drawn from ``generator`` (on ``device``;
    default: seed 0). The port's draws are its own: parity tests start from
    JAX's ``init_matcher`` through ``matcher_params_from_flax``.

    ``radius`` is in FEATURE pixels (search reach = radius * stride image
    px); ``bank`` > 0 adds the learned template selection.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = Matcher(dim=dim, radius=radius, hidden=hidden, stride=stride, fhidden=fhidden,
                    bank=bank).to(device)
    with torch.no_grad():
        for layer in model.modules():
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
                layer.bias.zero_()
    return model


def matcher_params_to_flax(matcher: Matcher) -> dict:
    """The inverse of ``matcher_params_from_flax``: a flax tree of numpy arrays
    (HWIO conv kernels, [in, out] dense kernels, ``config`` scalars), the
    layout ``tdspa/features/matcher.py`` initialises, saves and loads."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    tree = {
        "feature": {name: {"kernel": arr(getattr(matcher.feature, name).weight.permute(2, 3, 1, 0)),
                           "bias": arr(getattr(matcher.feature, name).bias)}
                    for name in ("conv0", "conv1")},
        "head": {name: {"kernel": arr(getattr(matcher.head, name).weight.T),
                        "bias": arr(getattr(matcher.head, name).bias)}
                 for name in ("fc0", "fc1", "fc_out")},
        "config": {name: np.asarray(getattr(matcher, name))
                   for name in ("dim", "radius", "hidden", "stride", "fhidden", "bank")},
    }
    if matcher.select is not None:
        tree["select"] = {"fc": {"kernel": arr(matcher.select.fc.weight.T),
                                 "bias": arr(matcher.select.fc.bias)}}
    return tree


def default_matcher_path() -> str:
    """This package's copy of the shipped matcher (template bank, bank=3)."""
    return os.path.join(os.path.dirname(__file__), "..", "assets", "matcher_default.npz")


def save_matcher(path: str, matcher: Matcher) -> None:
    """Flat ``.npz`` in flax names (``feature/conv0/kernel``, ...,
    ``config/bank``): the layout JAX's ``save_matcher`` writes and both
    packages' ``load_matcher`` read."""
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(name, v)
            else:
                flat[name] = np.asarray(v)

    walk("", matcher_params_to_flax(matcher))
    np.savez(path, **flat)


def load_matcher(path: str):
    """Flat ``.npz`` (``save_matcher``'s layout) -> nested tree of numpy arrays."""
    if path == "default":
        path = default_matcher_path()
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def _to_gray01(video):
    v = video.to(torch.float32)
    if v.shape[-1] == 3:  # [... H W 3]
        v = v @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=v.device)
    return v / 255.0


def compute_features(matcher: Matcher, video):
    """[T H W (3)] -> [T H/s W/s D] L2-normalised match features."""
    return matcher.feature(_to_gray01(video))


def _cost_patches_multi(feats, template_vecs, positions, radius: int, stride: int):
    """Cost patches against a template bank: [N M D] templates, [N T 2] IMAGE
    px -> [N T M K2]; the matcher kernel's function."""
    return cost_patches_multi(feats, template_vecs, img_to_feat(positions, stride), radius)


def _cost_patches(feats, template_vec, positions, radius: int, stride: int):
    """One template per point: [N D] -> [N T K2]."""
    return _cost_patches_multi(feats, template_vec[:, None], positions, radius, stride)[:, :, 0]


def _bank_stats(cost, dt):  # [... M K2], [... M] -> [... M 4]
    peak = torch.amax(cost, dim=-1)
    mean = torch.mean(cost, dim=-1)
    return torch.stack([peak, mean, peak - mean, dt], dim=-1)


def _build_bank(sampled, vis_logit, template_vec0, bank: int):
    """Visibility-gated historical template bank: per point and temporal
    segment the most-visible frame's vector, or the frame-0 template where
    the segment's best logit is <= 0. Returns (vecs [N bank+1 D], anchor
    frames [N bank+1] f32), frame-0 template first."""
    n, t, _ = sampled.shape
    bounds = np.linspace(0, t, bank + 1).astype(int)
    zeros = torch.zeros((n,), dtype=torch.float32, device=sampled.device)
    vecs, anchors = [template_vec0], [zeros]
    for m in range(bank):
        lo, hi = int(bounds[m]), int(bounds[m + 1])
        if hi <= lo:  # more segments than frames: duplicate frame 0
            vecs.append(template_vec0)
            anchors.append(zeros)
            continue
        seg = vis_logit[:, lo:hi]
        idx = torch.argmax(seg, dim=1)  # [N]
        vec = torch.gather(sampled[:, lo:hi], 1, idx[:, None, None].expand(-1, 1, sampled.shape[2]))[:, 0]
        conf = torch.gather(seg, 1, idx[:, None])[:, 0]
        ok = conf > 0.0
        vecs.append(torch.where(ok[:, None], vec, template_vec0))
        anchors.append(torch.where(ok, (idx + lo).to(torch.float32), zeros))
    return torch.stack(vecs, dim=1), torch.stack(anchors, dim=1)


def _field_candidate(x0, pos, vis_logit):
    """IDW-interpolated geometric candidate positions [N T 2] from the
    confident neighbours' displacements (frame-0 distances, self excluded)."""
    n, t = pos.shape[:2]
    disp = pos - x0[:, None, :]
    conf = (vis_logit > RESCUE_CONF).to(torch.float32)
    d2 = torch.sum((x0[:, None] - x0[None]) ** 2, -1)
    w = 1.0 / (d2 + RESCUE_SOFTEN)
    w = w * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))
    num = w @ (conf[..., None] * disp).reshape(n, t * 2)
    den = w @ conf + 1e-6
    dhat = num.reshape(n, t, 2) / den[..., None]
    return x0[:, None, :] + dhat


class _CostRoute:
    """One feature map's cost patches (``cost(pos, tvecs)``: [N T 2] IMAGE px,
    [N M D] templates -> [N T M K2]) and feature samples (``sample(pos)`` ->
    [N T D]): through the kernel wrappers (``csrc/matcher.cu`` and
    ``csrc/bilinear.cu`` on CUDA tensors; the runtime), or through their plain,
    differentiable versions (``plain=True``; training, the counterpart of
    JAX's XLA path, ``backend="xla"``)."""

    def __init__(self, feats, radius: int, stride: int, plain: bool):
        self.feats, self.radius, self.stride, self.plain = feats, radius, stride, plain

    def cost(self, pos, tvecs):
        fpos = img_to_feat(pos, self.stride)
        if self.plain:
            return cost_patches_reference(self.feats, tvecs, fpos, self.radius)
        return cost_patches_multi(self.feats, tvecs, fpos, self.radius)

    def sample(self, pos):
        fpos = img_to_feat(pos, self.stride)
        if self.plain:
            return bilinear_sample_reference(self.feats, fpos)
        return bilinear_sample(self.feats, fpos)


def _run_matcher(matcher: Matcher, route: _CostRoute, template_vec, tracks, iterations: int):
    """The (two-)phase refinement shared by the runtime and training: phase 1
    against the frame-0 template, then (bank > 0) phase 2 against the learned
    selection over the bank. Returns (positions [N T 2], vis logits [N T],
    the per-iteration list of (positions, vis logits) that training
    supervises)."""
    stride, bank = matcher.stride, matcher.bank
    steps = []
    pos = tracks
    vis = torch.zeros(tracks.shape[:2], dtype=torch.float32, device=tracks.device)
    for _ in range(iterations):
        cost = route.cost(pos, template_vec[:, None])[:, :, 0]
        delta, vis = matcher.head(cost)
        pos = pos + delta * float(stride)
        steps.append((pos, vis))
    if bank > 0:
        t = tracks.shape[1]
        frames = torch.arange(t, dtype=torch.float32, device=tracks.device)
        for _ in range(iterations):
            # Rebuilt each iteration from the current estimates.
            bankvecs, anchors = _build_bank(route.sample(pos), vis, template_vec, bank)
            cost = route.cost(pos, bankvecs)  # [N T M K2]
            dt = torch.abs(frames[None, :, None] - anchors[:, None, :]) / float(max(t, 1))
            w = matcher.select(_bank_stats(cost, dt))  # [N T M]
            fused = torch.einsum("ntm,ntmk->ntk", w, cost)
            delta, vis = matcher.head(fused)
            pos = pos + delta * float(stride)
            steps.append((pos, vis))
    return pos, vis, steps


@torch.inference_mode()
def refine_tracks(matcher: Matcher, video, tracks, iterations: int = 2, template_frame=None,
                  template_pos=None, refine_first: bool = False, rescue: int = 1):
    """Refine per-frame positions with the learned matcher.

    video [T H W (3)] uint8/f32 and tracks [N T 2] f32 on the matcher's
    device; ``template_frame`` [H W (3)] defaults to video[0] and
    ``template_pos`` [N 2] to tracks[:, 0]. Returns (tracks [N T 2], vis
    logits [N T]); frame 0 keeps its input position and a logit of 10 unless
    ``refine_first``. The cost patches and samples go through the kernels.
    """
    tracks = tracks.to(torch.float32)
    if template_frame is None:
        template_frame = video[0]
    if template_pos is None:
        template_pos = tracks[:, 0]
    stride = matcher.stride
    feats = compute_features(matcher, video)
    tfeats = compute_features(matcher, template_frame[None])
    template_vec = bilinear_sample(tfeats, img_to_feat(template_pos.to(torch.float32), stride)[:, None])[:, 0]
    route = _CostRoute(feats, matcher.radius, stride, plain=False)
    pos, vis, _ = _run_matcher(matcher, route, template_vec, tracks, iterations)
    for _ in range(rescue):
        cand = _field_candidate(tracks[:, 0], pos, vis)
        pos2, vis2, _ = _run_matcher(matcher, route, template_vec, cand, iterations)
        lost = vis < RESCUE_GATE
        switch_pos = lost & (vis2 > vis)
        switch_vis = lost & (vis2 > vis + RESCUE_MARGIN)
        pos = torch.where(switch_pos[..., None], pos2, pos)
        vis = torch.where(switch_vis, vis2 - RESCUE_PENALTY, vis)
    if not refine_first:
        pos = torch.cat([tracks[:, :1], pos[:, 1:]], dim=1)
        vis = torch.cat([torch.full_like(vis[:, :1], 10.0), vis[:, 1:]], dim=1)
    return pos, vis


def _quantile(x, q: float):
    return torch.quantile(x.reshape(-1), q)


@torch.inference_mode()
def _degradation_stats(video):
    """(noise p30 of |d2x|/sqrt(6) on 4 frames, luma p90-p10, flicker) as
    0-d tensors on the video's device; see tdspa/features/matcher.py."""
    v = video
    if v.dim() == 4 and v.shape[-1] == 3:
        rgb_w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=v.device)

        def luma_of(frames):
            return frames.to(torch.float32) @ rgb_w
    else:
        def luma_of(frames):
            return frames.to(torch.float32).reshape(frames.shape[:3])

    idx = np.linspace(0, v.shape[0] - 1, min(4, v.shape[0])).astype(int)
    sub = luma_of(v[torch.as_tensor(idx, device=v.device)])
    r = torch.abs(sub[:, :, 2:] - 2 * sub[:, :, 1:-1] + sub[:, :, :-2]) / np.sqrt(6.0)
    noise_p30 = _quantile(r, 0.30)
    contrast = _quantile(sub, 0.90) - _quantile(sub, 0.10)
    means = torch.mean(luma_of(v), dim=(1, 2))
    if v.shape[0] < 3:
        flicker = torch.zeros((), dtype=torch.float32, device=v.device)
    else:
        d2 = torch.abs(means[2:] - 2.0 * means[1:-1] + means[:-2])
        flicker = _quantile(d2, 0.5) / (torch.mean(means) + 1e-6)
    return noise_p30, contrast, flicker


def estimate_degradation(video) -> dict:
    """Photometric-degradation estimate -> dict with ``degraded`` (three
    scalar fetches)."""
    noise_p30, contrast, flicker = _degradation_stats(video)
    noise_sigma = float(noise_p30) / 0.37
    contrast = float(contrast)
    flicker = float(flicker)
    return {
        "noise_sigma": noise_sigma,
        "contrast": contrast,
        "flicker": flicker,
        "degraded": (
            noise_sigma >= AUTO_NOISE_SIGMA
            or contrast < AUTO_MIN_CONTRAST
            or flicker > AUTO_FLICKER
        ),
    }


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #


def make_training_scenes(num_scenes: int, seed: int = 0, num_frames: int = 16, height: int = 128,
                         width: int = 192, grid_size: int = 10, deform_amp_max: float = 0.0,
                         rot_rate_max: float = 0.0, natural_frac: float = 0.0):
    """Degradation-randomised synthetic scenes with exact ground truth:
    (videos [S T H W 3] uint8, tracks [S N T 2], visible [S N T]) numpy,
    equal to JAX's ``make_training_scenes`` for the same arguments.

    Each knob draws from the rng only when it is on, in JAX's order (a draw
    of ``uniform(0, 0)`` would still move every later scene): non-rigid warps
    (amp ~ U(0, ``deform_amp_max``)) on every other scene, camera roll
    (rad/frame ~ U(0, ``rot_rate_max``)) on every third, and the "natural"
    texture with a camera gamma in [1.6, 2.4] on a ``natural_frac`` share.
    """
    from tdspa_torch.utils.synthetic_video import make_tracking_scene

    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(num_scenes):
        pan = (int(rng.integers(-4, 5)), int(rng.integers(-3, 4)))
        scenes.append(make_tracking_scene(
            num_frames=num_frames,
            height=height,
            width=width,
            grid_size=grid_size,
            num_sprites=int(rng.integers(1, 4)),
            seed=seed * 1000 + i,
            pan=pan,
            noise_sigma=float(rng.uniform(0.0, 25.0)),
            contrast=float(rng.uniform(0.35, 1.0)),
            gain_flicker=float(rng.uniform(0.0, 0.25)),
            deform_amp=(float(rng.uniform(0.0, deform_amp_max))
                        if (deform_amp_max > 0.0 and i % 2) else 0.0),
            rot_rate=(float(rng.uniform(0.0, rot_rate_max))
                      if (rot_rate_max > 0.0 and i % 3 == 2) else 0.0),
            **({"texture": "natural", "camera_gamma": float(rng.uniform(1.6, 2.4))}
               if (natural_frac > 0.0 and rng.uniform() < natural_frac) else {}),
        ))
    return tuple(np.stack([scene[j] for scene in scenes]) for j in range(3))


def _huber(err, delta: float = 1.0):
    """optax's ``huber_loss``: 0.5 x^2 inside ``delta``, linear outside."""
    abs_err = err.abs()
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def _sigmoid_bce(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def matcher_loss(matcher: Matcher, video, gt_tracks, gt_visible, noise, iterations: int = 2,
                 occlusion_weight: float = 4.0):
    """JAX's training loss of one scene, from the start ``gt_tracks + noise``.

    The head refines the perturbed starts through ``_run_matcher`` on the
    plain, differentiable cost patches and samples (the template vector too),
    and every unrolled iteration is supervised: Huber (delta 1) on the
    position error summed over x and y, weighted by visibility and averaged
    over the visible (point, frame) pairs; sigmoid BCE on the visibility
    logit weighted ``vis + occlusion_weight * (1 - vis)``; each iteration
    scaled by 0.5 but the last (1.0). Returns (loss, pos_loss, vis_loss).
    """
    stride = matcher.stride
    feats = compute_features(matcher, video)
    template_vec = bilinear_sample_reference(feats[:1], img_to_feat(gt_tracks[:, :1], stride))[:, 0]
    route = _CostRoute(feats, matcher.radius, stride, plain=True)
    _, _, unrolled = _run_matcher(matcher, route, template_vec, gt_tracks + noise, iterations)
    vis = gt_visible
    w = vis + occlusion_weight * (1.0 - vis)
    pos_loss = vis_loss = 0.0
    for it, (pred, vis_logit) in enumerate(unrolled):
        scale = 1.0 if it == len(unrolled) - 1 else 0.5
        huber = _huber(pred - gt_tracks).sum(-1)
        pos_loss = pos_loss + scale * (huber * vis).sum() / torch.clamp(vis.sum(), min=1.0)
        vis_loss = vis_loss + scale * (_sigmoid_bce(vis_logit, vis) * w).sum() / w.sum()
    return pos_loss + vis_loss, pos_loss, vis_loss


def matcher_optimizer(learning_rate: float = 2e-3, steps: int = 1500) -> Optimizer:
    """JAX's ``optax.adamw`` with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every parameter, no clipping) on
    ``warmup_cosine_decay_schedule(0, lr, 50, steps, 0.05 lr)``."""
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, 50, steps, learning_rate * 0.05)
    return Optimizer(schedule, weight_decay=1e-4, clip_norm=None)


def matcher_train_step(matcher: Matcher, optimizer: Optimizer, opt_state: OptState, video,
                       gt_tracks, gt_visible, noise, iterations: int = 2,
                       occlusion_weight: float = 4.0):
    """One training step on one scene from the start perturbation ``noise``
    ([N T 2] image px): the loss's gradients of every parameter (``feature``,
    ``head`` and, with a bank, ``select``), then the AdamW update in place.
    Returns (the new optimizer state, (loss, pos_loss, vis_loss) as 0-d
    tensors)."""
    params = dict(matcher.named_parameters())
    losses = matcher_loss(matcher, video, gt_tracks, gt_visible, noise, iterations,
                          occlusion_weight)
    grads = torch.autograd.grad(losses[0], list(params.values()))
    opt_state = optimizer.update(grads, opt_state, params)
    return opt_state, tuple(x.detach() for x in losses)


def train_matcher(generator: torch.Generator | None = None, steps: int = 1500,
                  num_scenes: int = 24, learning_rate: float = 2e-3, dim: int = 16,
                  radius: int = 4, hidden: int = 128, stride: int = 2, fhidden: int = 32,
                  iterations: int = 2, bank: int = 0, occlusion_weight: float = 4.0,
                  scene_kwargs: dict | None = None, log_every: int = 50, device="cuda"):
    """Train the matcher on synthetic degraded scenes; JAX's
    ``train_matcher`` with ``generator`` (on ``device``; default seed 0) in
    place of its key. Returns (the trained ``Matcher``, log rows ``(step,
    loss, pos_loss, vis_loss)`` every ``log_every`` steps and at the last).

    One scene per step, cycled; each step perturbs the ground truth by
    ``U(-reach, reach)`` (reach = radius * stride image px, the head's
    search reach) drawn from ``generator``.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    videos, tracks, visible = make_training_scenes(num_scenes, **(scene_kwargs or {}))
    videos = torch.from_numpy(videos).to(device)
    tracks = torch.from_numpy(tracks).to(device)
    visible = torch.from_numpy(visible.astype(np.float32)).to(device)
    matcher = init_matcher(dim=dim, radius=radius, hidden=hidden, stride=stride,
                           fhidden=fhidden, bank=bank, generator=generator, device=device)
    optimizer = matcher_optimizer(learning_rate, steps)
    opt_state = optimizer.init(dict(matcher.named_parameters()))
    reach = float(radius * stride)
    log = []
    for i in range(steps):
        s = i % videos.shape[0]
        noise = torch.rand(tracks[s].shape, generator=generator, device=device)
        noise = (noise * 2.0 - 1.0) * reach
        opt_state, (loss, pos_loss, vis_loss) = matcher_train_step(
            matcher, optimizer, opt_state, videos[s], tracks[s], visible[s], noise,
            iterations, occlusion_weight)
        if i % log_every == 0 or i == steps - 1:
            log.append((i, float(loss), float(pos_loss), float(vis_loss)))
    return matcher, log


def main(argv: list[str] | None = None):
    """Train the matcher with JAX's flags and defaults: bank 3, 4000 steps,
    48 scenes of 24 frames, occlusion weight 8, roll <= 2.5 deg/frame,
    deformation <= 5 px, natural texture on half. Those defaults are the
    unshipped "matcher v2" recipe; the shipped asset is the round-4 recipe,
    cells-only: the same flags with ``--natural_frac=0``."""
    import argparse

    ap = argparse.ArgumentParser(description="Train the learned matcher (PyTorch/CUDA port).")
    ap.add_argument("out", nargs="?", default=default_matcher_path())
    ap.add_argument("--bank", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--num_scenes", type=int, default=48)
    ap.add_argument("--num_frames", type=int, default=24, help="training-scene length")
    ap.add_argument("--occlusion_weight", type=float, default=8.0)
    ap.add_argument("--rot_rate_max_deg", type=float, default=2.5,
                    help="camera-roll augmentation (deg/frame max; every third scene); 0 disables")
    ap.add_argument("--deform_amp_max", type=float, default=5.0,
                    help="non-rigid warp augmentation (px max; every other scene); 0 disables")
    ap.add_argument("--natural_frac", type=float, default=0.5,
                    help="fraction of scenes with the 'natural' texture and a camera gamma; "
                         "0 regenerates the round-4 cells-only distribution (the shipped asset)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    scene_kwargs = {"num_frames": args.num_frames}
    if args.rot_rate_max_deg > 0.0:
        scene_kwargs["rot_rate_max"] = float(np.deg2rad(args.rot_rate_max_deg))
    if args.deform_amp_max > 0.0:
        scene_kwargs["deform_amp_max"] = args.deform_amp_max
    if args.natural_frac > 0.0:
        scene_kwargs["natural_frac"] = args.natural_frac
    device = resolve_device(args.device)
    matcher, log = train_matcher(
        torch.Generator(device=device).manual_seed(args.seed), steps=args.steps, bank=args.bank,
        iterations=args.iterations, occlusion_weight=args.occlusion_weight,
        num_scenes=args.num_scenes, scene_kwargs=scene_kwargs, device=device,
    )
    save_matcher(args.out, matcher)
    print(f"saved {args.out} (bank={args.bank}); loss {log[0][1]:.3f} -> {log[-1][1]:.3f}")
    return matcher, log


if __name__ == "__main__":
    main()
