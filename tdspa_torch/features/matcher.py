"""Learned matching head over frame-0 cost volumes: the runtime half of
``tdspa/features/matcher.py``.

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

Weights are the flax tree of ``tdspa/features/matcher.py``
(``load_matcher``), mapped to the modules by ``matcher_params_from_flax``.
``load_matcher("default")`` reads this package's copy of the shipped
weights, ``tdspa_torch/assets/matcher_default.npz``. Training waits for the
training slice.

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

from tdspa_torch.kernels.matcher import cost_patches_multi, offset_grid
from tdspa_torch.ops.geometry import bilinear_sample

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


def default_matcher_path() -> str:
    """This package's copy of the shipped matcher (template bank, bank=3)."""
    return os.path.join(os.path.dirname(__file__), "..", "assets", "matcher_default.npz")


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


def _run_matcher(matcher: Matcher, feats, template_vec, tracks, iterations: int):
    """Phase 1 against the frame-0 template, then (bank > 0) phase 2 against
    the learned selection over the bank. Returns (positions [N T 2], vis
    logits [N T])."""
    stride, radius, bank = matcher.stride, matcher.radius, matcher.bank
    pos = tracks
    vis = torch.zeros(tracks.shape[:2], dtype=torch.float32, device=tracks.device)
    for _ in range(iterations):
        cost = _cost_patches(feats, template_vec, pos, radius, stride)
        delta, vis = matcher.head(cost)
        pos = pos + delta * float(stride)
    if bank > 0:
        t = tracks.shape[1]
        frames = torch.arange(t, dtype=torch.float32, device=tracks.device)
        for _ in range(iterations):
            sampled = bilinear_sample(feats, img_to_feat(pos, stride))
            bankvecs, anchors = _build_bank(sampled, vis, template_vec, bank)
            cost = _cost_patches_multi(feats, bankvecs, pos, radius, stride)  # [N T M K2]
            dt = torch.abs(frames[None, :, None] - anchors[:, None, :]) / float(max(t, 1))
            w = matcher.select(_bank_stats(cost, dt))  # [N T M]
            fused = torch.einsum("ntm,ntmk->ntk", w, cost)
            delta, vis = matcher.head(fused)
            pos = pos + delta * float(stride)
    return pos, vis


@torch.inference_mode()
def refine_tracks(matcher: Matcher, video, tracks, iterations: int = 2, template_frame=None,
                  template_pos=None, refine_first: bool = False, rescue: int = 1):
    """Refine per-frame positions with the learned matcher.

    video [T H W (3)] uint8/f32 and tracks [N T 2] f32 on the matcher's
    device; ``template_frame`` [H W (3)] defaults to video[0] and
    ``template_pos`` [N 2] to tracks[:, 0]. Returns (tracks [N T 2], vis
    logits [N T]); frame 0 keeps its input position and a logit of 10 unless
    ``refine_first``.
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
    pos, vis = _run_matcher(matcher, feats, template_vec, tracks, iterations)
    for _ in range(rescue):
        cand = _field_candidate(tracks[:, 0], pos, vis)
        pos2, vis2 = _run_matcher(matcher, feats, template_vec, cand, iterations)
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
