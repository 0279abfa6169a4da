"""Driver of the 3DSPA training step (``tdspa_torch.train.step.make_train_step``
on ``TrackAutoEncoder3D``): one step of the job's batch after another, on
one state, as ``train.py`` drives TRAJAN's.

The served configuration (``configs/spa3d.json``) holds no job, so the job's
settings (batch, optimizer, schedule, chunks) come from the traffic file's
``job`` and are laid over the configuration. Each example's support tracks
carry DINO and depth features as wide as the configuration's projections
take, normal(0, ``feature_std``) per channel as ``SyntheticTrackProvider``
draws them. Everything else, the checked first steps and the check against
``reference/train.py`` included, is ``train.py``'s.
"""

from __future__ import annotations

import torch

from benchmark.drivers import train
from benchmark.drivers.common import Stopwatch, program_model, sync
from benchmark.harness import generate, weights
from benchmark.reference.model import param_shapes


def features(batch: dict, config: dict, std: float, gen: torch.Generator, device) -> dict:
    """``batch`` with ``dino_features`` and ``depth_features`` [B, support, T, C]."""
    lead = batch["support_tracks"].shape[:-1]
    for key in ("dino_features", "depth_features"):
        width = config[key.replace("features", "feature_dim")]
        batch[key] = std * torch.randn(lead + (width,), generator=gen, device=device)
    return batch


class Cell(train.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.setup = Stopwatch()
        from tdspa_torch.train.state import TrainState, create_optimizer
        from tdspa_torch.train.step import make_train_step

        self.setup.mark("import_program")
        config = {**config, **traffic["job"]}
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
        self.batches = [features(generate.orbit_batch(traffic, config["batch_size"], 3, gen,
                                                      device),
                                 config, traffic["feature_std"], gen, device)
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
                                   for k, v in train._norms(self.state.opt_state.mu).items()}
            self.setup.mark(f"checked_step_{self.steps}")
        self.change = train._norms({k: p.detach() - self.weights[k]
                                    for k, p in self.state.params.items()})
