"""Driver of the scoring pipeline's depth path on Video Depth Anything
(``tdspa_torch.features.depth.VideoDepthEstimator`` with VDA's temporal head, then
``tdspa_torch.infer.pipeline.fused_tail``): closed loop, one request in flight. A request
is one video: its uint8 frames, on the card, through the estimator once, as
``InferencePipeline`` runs a ``depth_model`` (the span ``tdspa.video.depth``), then the
tail on the video's seeded tracks and DINO grid with that depth and a split of its own.

Set-up builds the estimator with the program's arguments for the configuration's model
name (``vda_model``) and the pipeline's knobs; a program without VDA's head fails here.
It checks that the estimator has the configuration's encoder, taps, head widths and
window schedule, then makes the weights from the
seed: the autoencoder's under the program's names, the depth model's under the released
checkpoint's (``reference/vda.py::param_shapes``, ``output_conv2.2``'s bias shifted by
the configuration's ``output_bias_offset``), carried into the program by
``convert_vda_params`` and ``params_from_flax``, the path a real checkpoint takes.
Set-up makes ``videos`` seeded videos with a front end each
(``harness/generate.py::front_ends``; its depth maps dropped) and a table of ``splits``
splits; request i takes video i mod ``videos`` and split i mod ``splits``.

``sample_requests`` seeded request indices among the first ``sample_from_first`` keep
their depth and predictions. After the window the plain reference recomputes each: the
depth model over every window, in blocks of ``reference_block_frames`` frames and
``reference_block_locations`` locations (``depth_gap``: each frame's RMS gap over the
RMS of the reference's variation about the frame's mean, the worst frame), then the
tail on the program's depth (``tracks_query_gap`` and ``visible_logits_query_gap``, as
in ``tail.py``), so each stage is checked on the input the program gave it.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import (DTYPES, Stopwatch, program_model, reference_mode,
                                      seeded_order, sync, worst_row)
from benchmark.harness import generate, weights
from benchmark.harness.runner import RunError
from benchmark.reference import tail as reference_tail
from benchmark.reference import vda as reference_vda
from benchmark.reference.model import Model, param_shapes
from benchmark.reference.precision import Precision

# Keys of the configuration's ``encoder`` that the program's ViT configuration holds
# under the same names.
ENCODER_KEYS = ("hidden_size", "num_layers", "num_heads", "mlp_ratio", "ffn", "patch_size",
                "image_size", "layer_norm_eps", "layerscale_value")
HEAD_KEYS = ("features", "out_channels", "layer_idxs")
PREFIX = "vda."


def frame_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst frame's RMS gap over the RMS of the reference's variation about that
    frame's mean: what the network computes, without the constant that the shifted
    output bias adds to every pixel."""
    want = want.float().flatten(1)
    gap = torch.linalg.vector_norm(got.float().flatten(1) - want, dim=1)
    spread = torch.linalg.vector_norm(want - want.mean(1, keepdim=True), dim=1)
    return float((gap / spread).max())


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.setup = Stopwatch()
        from tdspa_torch.features import depth
        from tdspa_torch.infer.pipeline import fused_tail
        from tdspa_torch.utils.profiling import span

        self.setup.mark("import_program")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.vda = config["depth"]
        self.depth = depth.VideoDepthEstimator(
            **depth.vda_model(self.vda["model_name"]),
            residual_dtype=DTYPES[config["residual_dtype"]], input_size=self.vda["input_size"],
            gelu_approximate=False, device=device)
        encoder = self.vda["encoder"]
        wrong = {k: (getattr(self.depth.vit_config, k, None), encoder[k]) for k in ENCODER_KEYS
                 if getattr(self.depth.vit_config, k, None) != encoder[k]}
        wrong.update({k: (self.depth.cfg[k], self.vda[k]) for k in HEAD_KEYS
                      if self.depth.cfg[k] != self.vda[k]})
        widths = reference_vda.motion_widths(self.vda)
        if list(self.depth.head.motion_widths) != widths:
            wrong["motion_widths"] = (list(self.depth.head.motion_widths), widths)
        schedule = [depth.VDA_WINDOW, depth.VDA_OVERLAP, list(depth.VDA_KEYFRAMES)]
        if schedule != [self.vda[k] for k in ("window", "overlap", "keyframes")]:
            wrong["window, overlap, keyframes"] = schedule
        if wrong:
            raise RunError(f"the program builds {self.vda['model_name']} otherwise than the "
                           f"configuration: (program, file) {wrong}")
        shapes = param_shapes(config)
        shapes.update({PREFIX + k: v for k, v in reference_vda.param_shapes(self.vda).items()})
        made = weights.make(shapes, seed, device)
        self.weights = {k: v for k, v in made.items() if not k.startswith(PREFIX)}
        self.vda_weights = {k[len(PREFIX):]: v for k, v in made.items() if k.startswith(PREFIX)}
        self.vda_weights[reference_vda.OUTPUT_BIAS] += self.vda["output_bias_offset"]
        sync(device)
        self.setup.mark("weights")
        self.model = program_model(config, device)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.depth.load_params(depth.convert_vda_params(
            self.vda_weights, encoder=encoder["preset"], vit_config=self.depth.vit_config))
        self._fused_tail, self._span = fused_tail, span
        sync(device)
        self.setup.mark("program_model")
        t = traffic
        gen = torch.Generator(device=device).manual_seed(weights.substream(seed, "traffic"))
        self.videos = [torch.randint(0, 256, (t["frames"], t["height"], t["width"], 3),
                                     generator=gen, device=device, dtype=torch.uint8)
                       for _ in range(t["videos"])]
        self.inputs = []
        for _ in range(t["videos"]):
            x = generate.front_ends(t, gen, device)
            del x["depth"]
            self.inputs.append(x)
        num_tracks = self.inputs[0]["tracks"].shape[0]
        self.perms, self.ts = generate.splits(t["splits"], num_tracks, t["queries"], t["frames"],
                                              gen, device)
        order = seeded_order(t["sample_from_first"], weights.substream(seed, "sample"))
        self.keep = set(order[: t["sample_requests"]])
        self.kept: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        sync(device)
        self.setup.mark("inputs")
        for k in range(t["warmup_requests"]):  # the window's shapes, its last splits
            self._serve(t["splits"] - 1 - k)
            self.setup.mark(f"warmup_{k}")
        self.kept.clear()

    def _video(self, i: int) -> torch.Tensor:
        return self.videos[i % len(self.videos)]

    def _tail_args(self, i: int, depth: torch.Tensor):
        """``fused_tail``'s arguments after the model for request ``i``."""
        x = self.inputs[i % len(self.inputs)]
        j = i % self.perms.shape[0]
        t = self.traffic
        return (x["tracks"], x["visible"], x["dino"], depth, self.perms[j], self.ts[j],
                t["support"], t["queries"], (t["height"], t["width"]))

    def _serve(self, i: int) -> None:
        with torch.inference_mode():
            with self._span("tdspa.video.depth"):
                depth = self.depth(self._video(i))
            preds, _, _ = self._fused_tail(self.model, *self._tail_args(i, depth))
        sync(self.device)
        if i in self.keep:
            self.kept[i] = (depth, preds.tracks, preds.visible_logits)

    def request(self, i: int) -> None:
        self._serve(i)

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = self.depth = None
        sync(self.device, empty_cache=True)

    def reference_depth(self, i: int, precision: str = "f32") -> torch.Tensor:
        """The depth of request ``i``'s video by the plain reference at ``precision``."""
        t = self.traffic
        with torch.no_grad():
            return reference_vda.VDA(self.vda, self.vda_weights, Precision(precision).round,
                                     t["reference_block_frames"],
                                     t["reference_block_locations"]).video(self._video(i))

    def reference(self, i: int, precision: str = "f32", depth: torch.Tensor | None = None):
        """(depth, tracks, visibility logits) of request ``i`` by the plain reference at
        ``precision``: its own depth, or the given ``depth``, and the tail on it."""
        if depth is None:
            depth = self.reference_depth(i, precision)
        with torch.no_grad():
            out = reference_tail.tail(Model(self.config, self.weights, Precision(precision)),
                                      *self._tail_args(i, depth))
        return depth, out["tracks"], out["visible_logits"]

    def readings(self, control: str | None = None) -> dict:
        """The numbers compared over the kept requests: the worst frame's gap of the
        program's depth (or, with ``control``, the reference's at that precision) against
        the f32 reference's, and the worst query's gap of its tracks and visibility logits
        against the f32 reference's tail on that same depth. The tail takes the depth
        through 32 Fourier frequencies up to 2**(31/3) a unit of the lifted coordinates, so
        a depth off by a thousandth turns its finest phases by more than a radian: fed each
        side's own depth, the tails would differ by that rounding, not by their own."""
        reference_mode(True)
        sample = sorted(self.kept)
        # Nothing compared is no pass.
        gaps = dict.fromkeys(("depth_gap", "tracks_query_gap", "visible_logits_query_gap"),
                             0.0 if sample else float("inf"))
        for i in sample:
            got = self.kept[i] if control is None else self.reference(i, control)
            gaps["depth_gap"] = max(gaps["depth_gap"], frame_gap(got[0], self.reference_depth(i)))
            want = self.reference(i, depth=got[0])
            gaps["tracks_query_gap"] = max(gaps["tracks_query_gap"], worst_row(got[1], want[1]))
            gaps["visible_logits_query_gap"] = max(gaps["visible_logits_query_gap"],
                                                   worst_row(got[2], want[2]))
            del want, got
        reference_mode(False)
        return gaps
