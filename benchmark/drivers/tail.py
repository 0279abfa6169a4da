"""Driver of the serving tail (``tdspa_torch.infer.pipeline.fused_tail``):
closed loop, one request in flight. A request is one video's tail: lift,
feature sampling, support/query split and the 3D autoencoder's forward.

Set-up makes the weights and a pool of ``input_sets`` seeded front-end
outputs on the card, and a table of ``splits`` support/query splits; request
i takes input set i mod ``input_sets`` and split i. A seeded subset of the
request indices (one in ``keep_every``) keeps its predictions; after the
window, up to ``sample_requests`` of those that finished are held to the
plain reference (``benchmark/reference/tail.py``): each query's tracks and
visibility logits (over its frames) by their gap to the reference's, over
the median query's norm there; the worst query counts.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import (Stopwatch, program_model, reference_mode, seeded_order,
                                      sync, worst_row)
from benchmark.harness import generate, weights
from benchmark.reference import tail as reference_tail
from benchmark.reference.model import Model, param_shapes
from benchmark.reference.precision import Precision

class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.setup = Stopwatch()
        from tdspa_torch.infer.pipeline import fused_tail

        self.setup.mark("import_program")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.weights = weights.make(param_shapes(config), seed, device)
        sync(device)
        self.setup.mark("weights")
        self.model = program_model(config, device)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self._fused_tail = fused_tail
        sync(device)
        self.setup.mark("program_model")
        gen = torch.Generator(device=device).manual_seed(weights.substream(seed, "traffic"))
        self.inputs = [generate.front_ends(traffic, gen, device)
                       for _ in range(traffic["input_sets"])]
        num_tracks = self.inputs[0]["tracks"].shape[0]
        self.perms, self.ts = generate.splits(traffic["splits"], num_tracks, traffic["queries"],
                                              traffic["frames"], gen, device)
        order = seeded_order(traffic["splits"], weights.substream(seed, "sample"))
        self.keep = set(order[: traffic["splits"] // traffic["keep_every"]])
        self.kept: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        sync(device)
        self.setup.mark("inputs")
        for k in range(traffic["warmup_requests"]):  # the window's shapes, its last splits
            self._serve(traffic["splits"] - 1 - k)
            self.setup.mark(f"warmup_{k}")
        self.kept.clear()

    def _args(self, i: int):
        x = self.inputs[i % len(self.inputs)]
        j = i % self.perms.shape[0]
        t = self.traffic
        return (x["tracks"], x["visible"], x["dino"], x["depth"], self.perms[j], self.ts[j],
                t["support"], t["queries"], (t["height"], t["width"]))

    def _serve(self, i: int) -> None:
        with torch.inference_mode():
            preds, _, _ = self._fused_tail(self.model, *self._args(i))
        sync(self.device)
        if i in self.keep:
            self.kept[i] = (preds.tracks, preds.visible_logits)

    def request(self, i: int) -> None:
        self._serve(i)

    def sample(self) -> list[int]:
        order = seeded_order(len(self.kept), weights.substream(self.seed, "judge"))
        done = sorted(self.kept)
        return sorted(done[k] for k in order[: self.traffic["sample_requests"]])

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        sync(self.device, empty_cache=True)

    def reference(self, i: int, precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
        model = Model(self.config, self.weights, Precision(precision))
        with torch.no_grad():
            out = reference_tail.tail(model, *self._args(i))
        return out["tracks"], out["visible_logits"]

    def readings(self, control: str | None = None) -> dict:
        """The numbers compared: the worst query's gap over the sample, of the
        program's tracks and visibility logits (or, with ``control``, the
        reference's at that precision) against the f32 reference."""
        reference_mode(True)
        sample = self.sample()
        # Nothing compared is no pass.
        gaps = {"tracks_query_gap": 0.0 if sample else float("inf"),
                "visible_logits_query_gap": 0.0 if sample else float("inf")}
        for i in sample:
            want = self.reference(i)
            got = self.kept[i] if control is None else self.reference(i, control)
            for name, a, b in zip(gaps, got, want):
                gaps[name] = max(gaps[name], worst_row(a, b))
        reference_mode(False)
        return gaps
