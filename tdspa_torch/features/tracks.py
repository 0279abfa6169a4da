"""2D point-track providers (port of ``tdspa/features/tracks.py``).

A provider maps a ``[T H W 3]`` video to ``{'tracks': [N T 2],
'visible': [N T 1]}``:

* ``PyramidalLKTracker``: pyramidal Lucas-Kanade on the pipeline's device,
  through the LK kernel (``tdspa_torch/csrc/lk.cu``) on a GPU and its plain
  version on the CPU, with the JAX package's ``auto`` escalation tiers
  (roll-stabilise, cost-volume rescue, denoise, learned matcher) and
  ``track_chunks`` for the streamed upload.
* ``StaticGridProvider`` and ``PrecomputedTrackProvider``: host providers.

``CoTrackerProvider`` (an external package) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tdspa_torch.features import matcher as matcher_lib
from tdspa_torch.kernels.lk import track_video_lk_kernel
from tdspa_torch.ops.filters import gaussian_blur_video
from tdspa_torch.ops.lk import to_gray
from tdspa_torch.ops.warp import apply_similarity, fit_similarity_sequence, warp_video_similarity
from tdspa_torch.utils.device import resolve_device

# Escalation constants of the 'auto' policy (tdspa/features/tracks.py, where
# each is measured and explained).
STAB_MIN_ANGLE_DEG = 30.0  # roll-stabilise gate: cumulative roll...
STAB_MIN_INLIER = 0.5  # ...with credible support,
STAB_MAX_ANGLE_DEG = 100.0  # within the warp's shear-pad budget
AUTO_DENOISE_SIGMA = 3.0  # denoise tier: blur of the re-tracked luma,
AUTO_DENOISE_MIN_NOISE = 4.0  # engaged only on noisy frames,
AUTO_DENOISE_MIN_DROP = 0.1  # kept only on a clear occluded-marking drop


def make_query_grid(height: int, width: int, grid_size: int) -> np.ndarray:
    """[grid_size^2, 2] (x, y) half-pixel-centered grid, row-major over (y, x)."""
    step_x, step_y = width / grid_size, height / grid_size
    j = np.tile(np.arange(grid_size), grid_size)
    i = np.repeat(np.arange(grid_size), grid_size)
    return np.stack([(j + 0.5) * step_x, (i + 0.5) * step_y], axis=1).astype(np.float32)


class StaticGridProvider:
    """Grid points, zero motion, full visibility (smoke-test fallback)."""

    def __init__(self, grid_size: int = 64):
        self.grid_size = grid_size

    def __call__(self, video) -> dict:
        t, h, w = video.shape[:3]
        grid = make_query_grid(h, w, self.grid_size)  # [N 2]
        tracks = np.broadcast_to(grid[:, None, :], (grid.shape[0], t, 2)).copy()
        visible = np.ones((grid.shape[0], t, 1), np.float32)
        return {"tracks": tracks.astype(np.float32), "visible": visible}


class PrecomputedTrackProvider:
    """Tracks from an .npz with 'tracks' [N T 2] and 'visible' [N T (1)]."""

    def __init__(self, npz_path: str):
        self.npz_path = npz_path

    def __call__(self, video) -> dict:
        with np.load(self.npz_path) as data:
            tracks = np.asarray(data["tracks"], np.float32)
            visible = np.asarray(data["visible"], np.float32)
        if visible.ndim == 2:
            visible = visible[..., None]
        return {"tracks": tracks, "visible": visible}


def _median(x: torch.Tensor) -> float:
    """jnp.median: the mean of the two middle values for an even count."""
    return float(torch.quantile(x.reshape(-1).to(torch.float32), 0.5))


class PyramidalLKTracker:
    """Pyramidal Lucas-Kanade grid tracker with the adaptive ``auto`` policy.

    ``device`` is where it tracks: ``"cuda"`` (the default) launches the LK
    and matcher kernels and raises without a GPU; ``"cpu"`` runs their plain
    versions. Other arguments as in ``tdspa.features.tracks.PyramidalLKTracker``;
    ``matcher`` is None, ``"auto"``, a path to a matcher ``.npz``, a
    ``load_matcher`` tree or a ``Matcher``.

    After each call ``tiers`` says which escalation tiers ran: ``stabilize``
    and ``matcher`` are True when they produced the result; ``rescue`` and
    ``denoise`` are True when their re-track was kept and False when it ran
    and was discarded; None means the tier did not run.
    """

    def __init__(
        self,
        grid_size: int = 64,
        num_levels: int = 3,
        window: int = 7,
        iterations: int = 4,
        fb_threshold: float = 2.0,
        ncc_threshold: float = 0.7,
        template_ncc_threshold: float = 0.5,
        corr_radius: int = 0,
        corr_iterations: int = 2,
        corr_accept: float = 0.85,
        corr_rescue_level: int = 0,
        matcher=None,
        matcher_vis_threshold: float = 0.5,
        device="cuda",
        input_scale: float = 1.0,
    ):
        self.device = resolve_device(device)
        self.grid_size = grid_size
        self.num_levels = num_levels
        self.window = window
        self.iterations = iterations
        self.input_scale = input_scale
        self.fb_threshold = fb_threshold
        self.ncc_threshold = ncc_threshold
        self.template_ncc_threshold = template_ncc_threshold
        self.corr_radius = corr_radius
        self.corr_iterations = corr_iterations
        self.corr_accept = corr_accept
        self.corr_rescue_level = corr_rescue_level
        if isinstance(matcher, str) and matcher != "auto":
            matcher = matcher_lib.load_matcher(matcher)
        if isinstance(matcher, dict):
            matcher = matcher_lib.matcher_params_from_flax(matcher, self.device)
        self.matcher = matcher
        self._auto_matcher = None
        self.matcher_vis_threshold = matcher_vis_threshold
        self.tiers = self._no_tiers()

    @staticmethod
    def _no_tiers() -> dict:
        return {"stabilize": None, "rescue": None, "denoise": None, "matcher": None}

    def backend_for(self, video_shape) -> str:
        """``"cuda"`` (the kernels) or ``"cpu"`` (their plain versions)."""
        return self.device.type

    def prefers_device_input(self, video_shape) -> bool:
        """True: the tracker consumes the video on its device, so the
        pipeline shares its one upload (and streams it, see track_chunks)."""
        return True

    def _kwargs(self) -> dict:
        return dict(
            num_levels=self.num_levels, window=self.window, iterations=self.iterations,
            fb_threshold=self.fb_threshold, ncc_threshold=self.ncc_threshold,
            template_ncc_threshold=self.template_ncc_threshold, corr_radius=self.corr_radius,
            corr_iterations=self.corr_iterations, corr_accept=self.corr_accept,
            corr_rescue_level=self.corr_rescue_level, input_scale=self.input_scale,
        )

    def _queries(self, h: int, w: int) -> torch.Tensor:
        return torch.as_tensor(make_query_grid(h, w, self.grid_size), device=self.device)

    def _matcher_for(self, video, lk_visible=None, rescue_drop=0.0, denoised=False):
        """The matcher to apply to this video (None = don't): in 'auto' mode
        on photometric degradation or an unrescued tracking collapse, never
        after an accepted denoised re-track."""
        if self.matcher is None:
            return None
        if not isinstance(self.matcher, str):
            return self.matcher
        engage = not denoised and (
            matcher_lib.estimate_degradation(video)["degraded"]
            or (lk_visible is not None and rescue_drop < 0.1 and self._collapse_engage(lk_visible))
        )
        return self._default_matcher() if engage else None

    def _default_matcher(self):
        if self._auto_matcher is None:
            self._auto_matcher = matcher_lib.matcher_params_from_flax(
                matcher_lib.load_matcher("default"), self.device
            )
        return self._auto_matcher

    def _maybe_rescue(self, run, kwargs, tracks, visible):
        """'auto': on a collapsed pass, re-track with the frame-0 cost volume
        and the coarse rescue; kept when occluded-marking drops by > 0.02.
        Returns (tracks, visible, drop)."""
        if not (isinstance(self.matcher, str) and self.corr_radius == 0
                and self._collapse_engage(visible)):
            return tracks, visible, 0.0
        rescued_tracks, rescued_visible = run(dict(kwargs, corr_radius=4, corr_rescue_level=2))
        drop = self._occluded_frac(visible) - self._occluded_frac(rescued_visible)
        self.tiers["rescue"] = drop > 0.02
        if drop > 0.02:
            return rescued_tracks, rescued_visible, drop
        return tracks, visible, 0.0

    def _maybe_denoise(self, retrack, video, kwargs, tracks, visible, noise_sigma=None):
        """'auto': on a pass still collapsed after the rescue, with noisy
        frames, re-track on Gaussian-blurred luma; kept when occluded-marking
        drops by > AUTO_DENOISE_MIN_DROP. ``video`` is a zero-argument
        callable. Returns (tracks, visible, engaged)."""
        if not (isinstance(self.matcher, str) and self.corr_radius == 0
                and self._collapse_engage(visible)):
            return tracks, visible, False
        if noise_sigma is None:
            noise_sigma = matcher_lib.estimate_degradation(video())["noise_sigma"]
        if noise_sigma < AUTO_DENOISE_MIN_NOISE:
            return tracks, visible, False
        blurred = gaussian_blur_video(to_gray(video()) * 255.0, sigma=AUTO_DENOISE_SIGMA)
        d_tracks, d_visible = retrack(blurred, kwargs)
        drop = self._occluded_frac(visible) - self._occluded_frac(d_visible)
        self.tiers["denoise"] = drop > AUTO_DENOISE_MIN_DROP
        if drop > AUTO_DENOISE_MIN_DROP:
            return d_tracks, d_visible, True
        return tracks, visible, False

    def _maybe_stabilize(self, tracks):
        """'auto' roll gate: the global similarity fitted from the tracks
        when its cumulative roll is at least STAB_MIN_ANGLE_DEG (and at most
        STAB_MAX_ANGLE_DEG) with median inlier share >= STAB_MIN_INLIER."""
        if not isinstance(self.matcher, str) or tracks.shape[1] < 2:
            return None
        fit = fit_similarity_sequence(tracks)
        max_angle = float(torch.amax(torch.abs(fit["angle_deg"])))
        med_inl = _median(fit["inlier_frac"][1:])
        if max_angle < STAB_MIN_ANGLE_DEG or med_inl < STAB_MIN_INLIER:
            return None
        if max_angle > STAB_MAX_ANGLE_DEG:
            return None
        return fit

    def _stabilized_result(self, video, fit):
        """Counter-warp the luma to the frame-0 orientation, re-track it
        with the rest of the policy, map positions back; visibility ANDed
        with an in-bounds test of the mapped positions."""
        self.tiers["stabilize"] = True
        h, w = video.shape[1], video.shape[2]
        gray = to_gray(video) * 255.0
        pad_h, pad_w = (-h) % 8, (-w) % 8
        if pad_h or pad_w:  # the warp needs multiples of 8: edge-pad bottom/right
            gray = F.pad(gray[:, None], (0, pad_w, 0, pad_h), mode="replicate")[:, 0]
        stab = warp_video_similarity(gray, fit["A"], fit["t"])
        if pad_h or pad_w:
            stab = stab[:, :h, :w]
        out = self.__call__(stab, _allow_stabilize=False)
        mapped = apply_similarity(fit["A"], fit["t"], out["tracks"])
        in_bounds = (
            (mapped[..., 0] >= 0) & (mapped[..., 0] <= w - 1)
            & (mapped[..., 1] >= 0) & (mapped[..., 1] <= h - 1)
        )
        return {"tracks": mapped, "visible": out["visible"] * in_bounds[..., None]}

    def _apply_matcher(self, video, tracks, matcher):
        """Learned-matcher post-pass: refined positions, and the learned
        visibility logit (> matcher_vis_threshold) ANDed with in-bounds."""
        self.tiers["matcher"] = True
        pos, vis_logit = matcher_lib.refine_tracks(matcher, video, tracks)
        h, w = video.shape[1], video.shape[2]
        in_bounds = (
            (pos[..., 0] >= 0) & (pos[..., 0] <= w - 1)
            & (pos[..., 1] >= 0) & (pos[..., 1] <= h - 1)
        )
        vis = ((vis_logit > self.matcher_vis_threshold) & in_bounds).to(torch.float32)[..., None]
        return pos, vis

    def _to_device(self, video) -> torch.Tensor:
        return torch.as_tensor(video, device=self.device)

    @torch.inference_mode()
    def __call__(self, video, _allow_stabilize: bool = True) -> dict:
        """Track the grid through ``video`` ([T H W 3] uint8 or luma
        [T H W]); returns tensors on the tracker's device."""
        video = self._to_device(video)
        if _allow_stabilize:
            self.tiers = self._no_tiers()
        t, h, w = video.shape[:3]
        queries = self._queries(h, w)
        kwargs = self._kwargs()
        tracks, visible = track_video_lk_kernel(video, queries, **kwargs)
        # Two-tier roll gate: on the first pass's tracks, and again only
        # when an accepted rescue changed them.
        if _allow_stabilize:
            fit = self._maybe_stabilize(tracks)
            if fit is not None:
                return self._stabilized_result(video, fit)
        tracks, visible, rescue_drop = self._maybe_rescue(
            lambda kw: track_video_lk_kernel(video, queries, **kw), kwargs, tracks, visible
        )
        if _allow_stabilize and rescue_drop > 0.0:
            fit = self._maybe_stabilize(tracks)
            if fit is not None:
                return self._stabilized_result(video, fit)
        tracks, visible, denoised = self._maybe_denoise(
            lambda vid, kw: track_video_lk_kernel(vid, queries, **kw),
            lambda: video, kwargs, tracks, visible,
        )
        m = self._matcher_for(video, lk_visible=visible, rescue_drop=rescue_drop, denoised=denoised)
        if m is not None:
            tracks, visible = self._apply_matcher(video, tracks, m)
        return {"tracks": tracks, "visible": visible}

    @torch.inference_mode()
    def track_chunks(self, chunks) -> dict:
        """Track across consecutive video chunks ([Tc H W 3] tensors on the
        tracker's device), one LK launch per chunk.

        Each continuation chunk is prepended with the previous chunk's last
        frame and its frame-0 output dropped; the positions, the velocity
        prior and the frame-0 template carry across, so the result equals one
        call on the concatenated video. The 'auto' decisions come after the
        last chunk: the matcher engages if ANY chunk looks degraded.
        """
        self.tiers = self._no_tiers()
        chunks = [self._to_device(c) for c in chunks]
        h, w = chunks[0].shape[1], chunks[0].shape[2]
        kwargs = self._kwargs()
        queries = self._queries(h, w)
        pos, vel = queries, torch.zeros_like(queries)
        template_frame = to_gray(chunks[0][:1])[0]
        auto_mode = isinstance(self.matcher, str)
        chunk_stats, all_tracks, all_vis = [], [], []
        prev_last = None
        for c in chunks:
            seg = c if prev_last is None else torch.cat([prev_last[None], c], dim=0)
            tr, vi, vel = track_video_lk_kernel(
                seg, pos, template_frame=template_frame, template_pos=queries,
                init_velocity=vel, return_velocity=True, **kwargs,
            )
            if prev_last is not None:
                tr, vi = tr[:, 1:], vi[:, 1:]
            if auto_mode:
                chunk_stats.append(matcher_lib._degradation_stats(c))  # device scalars
            all_tracks.append(tr)
            all_vis.append(vi)
            pos = tr[:, -1]
            prev_last = c[-1]
        tracks = torch.cat(all_tracks, dim=1)
        visible = torch.cat(all_vis, dim=1)
        full = []

        def video():  # the concatenation, made only when a tier needs it
            if not full:
                full.append(torch.cat(chunks, dim=0))
            return full[0]

        fit = self._maybe_stabilize(tracks)
        if fit is not None:
            return self._stabilized_result(video(), fit)
        tracks, visible, rescue_drop = self._maybe_rescue(
            lambda kw: track_video_lk_kernel(
                video(), queries, template_frame=template_frame, template_pos=queries, **kw
            ),
            kwargs, tracks, visible,
        )
        if rescue_drop > 0.0:
            fit = self._maybe_stabilize(tracks)
            if fit is not None:
                return self._stabilized_result(video(), fit)
        tracks, visible, denoised = self._maybe_denoise(
            lambda vid, kw: track_video_lk_kernel(vid, queries, **kw), video, kwargs,
            tracks, visible,
            noise_sigma=(max(float(s[0]) / 0.37 for s in chunk_stats) if chunk_stats else None),
        )
        matcher = None if auto_mode else self.matcher
        if chunk_stats and not denoised and (
            self._auto_engage(chunk_stats)
            or (rescue_drop < 0.1 and self._collapse_engage(visible))
        ):
            matcher = self._default_matcher()
        if matcher is not None:
            tracks, visible = self._apply_matcher(video(), tracks, matcher)
        return {"tracks": tracks, "visible": visible}

    @staticmethod
    def _auto_engage(chunk_stats) -> bool:
        """Engage if ANY chunk's stats cross the auto thresholds."""
        for noise_p30, contrast, flicker in chunk_stats:
            if (
                float(noise_p30) / 0.37 >= matcher_lib.AUTO_NOISE_SIGMA
                or float(contrast) < matcher_lib.AUTO_MIN_CONTRAST
                or float(flicker) > matcher_lib.AUTO_FLICKER
            ):
                return True
        return False

    @staticmethod
    def _occluded_frac(visible) -> float:
        """Marked-occluded share of (point, frame) pairs (one scalar fetch)."""
        return 1.0 - float(torch.mean(visible.to(torch.float32)))

    @classmethod
    def _collapse_engage(cls, visible) -> bool:
        """True if the classical pass collapsed (marks an implausibly large
        share of pairs occluded)."""
        return cls._occluded_frac(visible) > matcher_lib.AUTO_LK_OCCLUDED_FRAC
