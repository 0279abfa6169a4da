"""Driver of the training step (``tdspa_torch.train.step.make_train_step``):
one step of the configuration's batch after another, on one state.

Set-up makes the weights and a pool of ``batches`` seeded batches on the
card, builds the train state once and drives it through its first
``checked_steps`` steps by the window's own call, each on a batch of its own;
the window goes on from that state, the pool taken in turn. The optimizer is
the configuration's (global-norm clip and AdamW on a warmup-cosine
schedule).

Held to the plain reference (``benchmark/reference/train.py``), which
follows the same first steps from the same weights and batches, at rates it
works out from the configuration itself: the norm of every leaf's first
gradient as the optimizer took it (worked out from its first moment after
one step), by the worst leaf, and the norm of every leaf's change after the
checked steps, by the worst and by the median leaf. Each step's loss is
kept for the calibration's record, not compared: the fp8 control reads
there within twice the program's largest gap, so no limit between them
holds (``benchmark/limits/trajan2d.train.json``).
"""

from __future__ import annotations

import statistics

import torch

from benchmark.drivers.common import (Stopwatch, median_leaf, program_model, reference_mode, sync,
                                      worst_leaf)
from benchmark.harness import generate, weights
from benchmark.reference import train as reference_train
from benchmark.reference.model import is_3d, param_shapes
from benchmark.reference.precision import Precision

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam: left out of the change's comparison.
STILL_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]).tolist()
    return dict(zip(names, values))


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.setup = Stopwatch()
        from tdspa_torch.train.state import TrainState, create_optimizer
        from tdspa_torch.train.step import make_train_step

        self.setup.mark("import_program")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.weights = weights.make(param_shapes(config), seed, device)
        sync(device)
        self.setup.mark("weights")
        model = program_model(config, device)
        model.load_state_dict(self.weights)
        optimizer, schedule = create_optimizer(
            config["learning_rate"], config["warmup_steps"], config["total_steps"],
            config["weight_decay"], config["clip_norm"])
        params = dict(model.named_parameters())
        self.state = TrainState(params=params, opt_state=optimizer.init(params), step=0)
        self.b1 = optimizer.b1
        self._step = make_train_step(model, optimizer, schedule)
        gen = torch.Generator(device=device).manual_seed(weights.substream(seed, "traffic"))
        coords = 3 if is_3d(config) else 2
        self.batches = [generate.orbit_batch(traffic, config["batch_size"], coords, gen, device)
                        for _ in range(traffic["batches"])]
        sync(device)
        self.setup.mark("program_and_inputs")
        self.steps = 0
        self.losses: list[float] = []
        self.first_grad: dict | None = None
        for _ in range(traffic["checked_steps"]):
            self.request(None)
            self.losses.append(float(self.metrics["train/loss"]))
            if self.first_grad is None:  # optax's mu after one step is (1 - b1) g
                self.first_grad = {k: v / (1 - self.b1)
                                   for k, v in _norms(self.state.opt_state.mu).items()}
            self.setup.mark(f"checked_step_{self.steps}")
        self.change = _norms({k: p.detach() - self.weights[k]
                              for k, p in self.state.params.items()})

    def request(self, _i) -> None:
        batch = self.batches[self.steps % len(self.batches)]
        self.state, self.metrics = self._step(self.state, batch)
        self.steps += 1
        sync(self.device)

    def release_program(self) -> None:
        self.state = self._step = self.metrics = None
        sync(self.device, empty_cache=True)

    def reference(self, precision: str = "f32", fault: str | None = None) -> dict:
        n = self.traffic["checked_steps"]
        batches = [self.batches[k % len(self.batches)] for k in range(n)]
        kwargs = {"chunk": self.config.get("encoder_scan_chunk_size"),
                  "precision": Precision(precision)}
        return reference_train.run_steps(self.config, self.weights, batches, kwargs, fault=fault)

    @staticmethod
    def gaps(got: dict, want: dict) -> dict:
        grads = want["first_grad"]
        median = statistics.median(grads.values())
        moving = {k for k, g in grads.items() if g >= STILL_LEAF * median}
        return {
            "first_grad_leaf": worst_leaf(got["first_grad"], grads),
            "change_leaf": worst_leaf(got["change"], want["change"], keep=moving),
            "change_median": median_leaf(got["change"], want["change"], keep=moving),
        }

    def program(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}

    def readings(self, control: str | None = None) -> dict:
        """The numbers compared, the program's (or, with ``control``, the
        reference's at that precision) against the f32 reference."""
        reference_mode(True)
        want = self.reference()
        got = self.program() if control is None else self.reference(control)
        reference_mode(False)
        return self.gaps(got, want)
