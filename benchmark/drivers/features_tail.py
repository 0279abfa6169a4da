"""Driver of the scoring pipeline's semantic path on a DINOv2 backbone
(``tdspa_torch.features.dino.DinoFeatureExtractor``, then
``tdspa_torch.infer.pipeline.fused_tail``): closed loop, one request in
flight. A request is one video: its uint8 frames, on the card, through the
extractor chunk by chunk as the pipeline uploads them (each chunk the span
``tdspa.video.dino``, as in ``InferencePipeline``), then the tail on the
DINO grid with the video's seeded tracks and depth maps and a split of its
own.

Set-up checks that the program's configuration of the backbone's model name
(``dino_config``) is the configuration file's ``backbone``, then makes the
weights from the seed: the autoencoder's under the program's names, the
backbone's under the published checkpoint's (``reference/dinov2.py::
param_shapes``), carried into the program by ``convert_hf_dinov2_params``
and ``params_from_flax``, the path a real checkpoint takes. The extractor is
built with the arguments ``InferencePipeline.dino_extractor`` gives it, the
weights passed in. Set-up makes ``videos`` seeded videos with a front end
each (``harness/generate.py::front_ends``, its DINO grid left to the
backbone) and a table of ``splits`` splits; request i takes video i mod
``videos`` and split i mod ``splits``.

``sample_requests`` seeded request indices among the first
``sample_from_first`` keep their DINO grid and predictions. After the window
the plain reference recomputes each: the backbone over every frame in blocks
of ``reference_block_frames`` (``dino_token_gap``: the worst patch token's
gap over the median token's norm), then the tail fed the reference's own
grid (``tracks_query_gap`` and ``visible_logits_query_gap``, as in
``tail.py``), so the check runs end to end.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import (DTYPES, Stopwatch, program_model, reference_mode,
                                      seeded_order, sync, worst_row)
from benchmark.harness import generate, weights
from benchmark.harness.runner import RunError
from benchmark.reference import dinov2 as reference_dinov2
from benchmark.reference import tail as reference_tail
from benchmark.reference.model import Model, param_shapes
from benchmark.reference.precision import Precision

# Keys of the configuration's ``backbone`` that the program's ViT
# configuration holds under the same names.
BACKBONE_KEYS = ("hidden_size", "num_layers", "num_heads", "mlp_ratio", "ffn", "patch_size",
                 "image_size", "layer_norm_eps", "layerscale_value")
PREFIX = "backbone."


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.setup = Stopwatch()
        from tdspa_torch.features.dino import DinoFeatureExtractor, dino_config
        from tdspa_torch.features.vit import convert_hf_dinov2_params
        from tdspa_torch.infer.pipeline import fused_tail
        from tdspa_torch.utils.profiling import span

        self.setup.mark("import_program")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.backbone = config["backbone"]
        vit = dino_config(self.backbone["model_name"])
        wrong = {k: (getattr(vit, k, None), self.backbone[k]) for k in BACKBONE_KEYS
                 if getattr(vit, k, None) != self.backbone[k]}
        if wrong:
            raise RunError(f"the program builds {self.backbone['model_name']} otherwise than "
                           f"the configuration: (program, file) {wrong}")
        shapes = param_shapes(config)
        shapes.update({PREFIX + k: v
                       for k, v in reference_dinov2.param_shapes(self.backbone).items()})
        made = weights.make(shapes, seed, device)
        self.weights = {k: v for k, v in made.items() if not k.startswith(PREFIX)}
        self.dino_weights = {k[len(PREFIX):]: v for k, v in made.items() if k.startswith(PREFIX)}
        sync(device)
        self.setup.mark("weights")
        self.model = program_model(config, device)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.dino = DinoFeatureExtractor(
            model_name=self.backbone["model_name"],
            params=convert_hf_dinov2_params(self.dino_weights, vit),
            residual_dtype=DTYPES[config["residual_dtype"]], gelu_approximate=False,
            device=device)
        self._fused_tail, self._span = fused_tail, span
        sync(device)
        self.setup.mark("program_model")
        t = traffic
        gen = torch.Generator(device=device).manual_seed(weights.substream(seed, "traffic"))
        self.videos = [torch.randint(0, 256, (t["frames"], t["height"], t["width"], 3),
                                     generator=gen, device=device, dtype=torch.uint8)
                       for _ in range(t["videos"])]
        self.inputs = [generate.front_ends({**t, "dino_grid": (0, 0, 0)}, gen, device)
                       for _ in range(t["videos"])]
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

    def _tail_args(self, i: int, grid: torch.Tensor):
        """``fused_tail``'s arguments after the model for request ``i``."""
        x = self.inputs[i % len(self.inputs)]
        j = i % self.perms.shape[0]
        t = self.traffic
        return (x["tracks"], x["visible"], grid, x["depth"], self.perms[j], self.ts[j],
                t["support"], t["queries"], (t["height"], t["width"]))

    def _serve(self, i: int) -> None:
        video, chunk = self._video(i), self.traffic["upload_chunk_frames"]
        with torch.inference_mode():
            parts = []
            for start in range(0, video.shape[0], chunk):
                with self._span("tdspa.video.dino"):
                    parts.append(self.dino(video[start : start + chunk]))
            grid = torch.cat(parts)
            preds, _, _ = self._fused_tail(self.model, *self._tail_args(i, grid))
        sync(self.device)
        if i in self.keep:
            self.kept[i] = (grid, preds.tracks, preds.visible_logits)

    def request(self, i: int) -> None:
        self._serve(i)

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = self.dino = None
        sync(self.device, empty_cache=True)

    def reference(self, i: int, precision: str = "f32"):
        """(DINO grid, tracks, visibility logits) of request ``i`` by the
        plain reference, the tail fed the reference's own grid."""
        p = Precision(precision)
        with torch.no_grad():
            grid = reference_dinov2.Backbone(self.backbone, self.dino_weights, p).patch_grid(
                self._video(i), self.traffic["reference_block_frames"])
            out = reference_tail.tail(Model(self.config, self.weights, p),
                                      *self._tail_args(i, grid))
        return grid, out["tracks"], out["visible_logits"]

    def readings(self, control: str | None = None) -> dict:
        """The numbers compared over the kept requests: the worst patch
        token's gap of the program's DINO grid (or, with ``control``, the
        reference's at that precision) and the worst query's gap of its
        tracks and visibility logits, against the f32 reference."""
        reference_mode(True)
        sample = sorted(self.kept)
        # Nothing compared is no pass.
        gaps = dict.fromkeys(("dino_token_gap", "tracks_query_gap", "visible_logits_query_gap"),
                             0.0 if sample else float("inf"))
        for i in sample:
            want = self.reference(i)
            got = self.kept[i] if control is None else self.reference(i, control)
            width = want[0].shape[-1]
            pairs = {"dino_token_gap": (got[0].reshape(1, -1, width),
                                        want[0].reshape(1, -1, width)),
                     "tracks_query_gap": (got[1], want[1]),
                     "visible_logits_query_gap": (got[2], want[2])}
            for name, (a, b) in pairs.items():
                gaps[name] = max(gaps[name], worst_row(a, b))
            del want, got, pairs
        reference_mode(False)
        return gaps
