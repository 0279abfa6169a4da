"""Train state, model factory and optimizer (port of ``tdspa/train/state.py``).

The optimizer is optax's ``chain(clip_by_global_norm(clip_norm),
adamw(schedule, weight_decay=weight_decay))`` written out, because
``torch.nn.utils.clip_grad_norm_`` is not optax's clip (it scales by
``max_norm / (norm + 1e-6)`` and always multiplies): gradients are kept when
their global norm is below ``clip_norm`` and otherwise become
``g / norm * clip_norm``; AdamW takes b1 0.9, b2 0.999, eps 1e-8 added to
``sqrt(v_hat)``, decays every parameter, and update ``i`` (from 0) uses the
rate ``schedule(i)``, which is 0 under warmup.

A ``TrainState``'s ``params`` are the model's own parameters: the steps
update them in place (the JAX steps donate the state's buffers).
"""

from __future__ import annotations

import dataclasses

import torch

from tdspa_torch.models import TrackAutoEncoder, TrackAutoEncoder3D
from tdspa_torch.train.schedule import create_learning_rate_schedule


@dataclasses.dataclass
class OptState:
    """optax's ``ScaleByAdamState``: update count and both moments."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: OptState
    step: int

    def replace(self, **changes) -> TrainState:
        return dataclasses.replace(self, **changes)


class Optimizer:
    """Global-norm clip + AdamW on ``schedule`` (optax's update, in place);
    ``clip_norm=None`` is ``optax.adamw`` alone (the matcher's training)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which JAX's trainer uses

    def __init__(self, schedule, weight_decay: float = 0.01, clip_norm: float | None = 1.0):
        self.schedule = schedule
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        return OptState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads, state: OptState, params: dict[str, torch.Tensor]) -> OptState:
        """Apply one update to ``params`` in place (``grads`` in their order)
        and return the new optimizer state, whose moments are ``state``'s,
        updated in place."""
        names = list(params)
        p = [params[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        g = list(grads)
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            clipped = torch._foreach_div(g, norm)
            torch._foreach_mul_(clipped, self.clip_norm)
            keep = norm < self.clip_norm
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
            del clipped
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu.
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_add_(nu, g2)
        del g, g2
        count = state.count + 1
        # optax's bias corrections 1 - b**count, in f32.
        bc1 = float(torch.tensor(1 - self.b1 ** count, dtype=torch.float32))
        bc2 = float(torch.tensor(1 - self.b2 ** count, dtype=torch.float32))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -self.schedule(state.count))
        torch._foreach_add_(p, upd)
        return OptState(count=count, mu=state.mu, nu=state.nu)


def build_model(model_type: str = "3dspa", num_output_frames: int = 150, use_dino: bool = True,
                use_depth: bool = True, dtype=None, device="cuda", seed: int = 0, **overrides):
    """Model factory keyed by the reference's ``model_type`` flag values."""
    kwargs = dict(num_output_frames=num_output_frames, device=device, seed=seed, **overrides)
    if dtype is not None:
        kwargs["dtype"] = dtype
    if model_type == "3dspa":
        return TrackAutoEncoder3D(use_dino=use_dino, use_depth=use_depth, **kwargs)
    if model_type == "trajan":
        return TrackAutoEncoder(**kwargs)
    raise ValueError(f"Unknown model_type: {model_type!r} (trajan | 3dspa)")


def create_optimizer(learning_rate: float = 1e-4, warmup_steps: int = 10_000,
                     total_steps: int = 1_000_000, weight_decay: float = 0.01,
                     clip_norm: float = 1.0):
    """(optimizer, schedule): global-norm clip + AdamW on a warmup-cosine schedule."""
    schedule = create_learning_rate_schedule(learning_rate, warmup_steps, total_steps)
    return Optimizer(schedule, weight_decay=weight_decay, clip_norm=clip_norm), schedule


def create_model_state(seed: int = 0, model_type: str = "3dspa", learning_rate: float = 1e-4,
                       warmup_steps: int = 10_000, total_steps: int = 1_000_000,
                       num_output_frames: int = 150, use_dino: bool = True,
                       use_depth: bool = True, device="cuda", **model_overrides):
    """(state, model, optimizer, schedule) with the model's seeded init on
    ``device`` (GPU unless ``device="cpu"``). JAX draws its init from a
    ``PRNGKey``; the port's is its own, with the same laws."""
    model = build_model(model_type, num_output_frames=num_output_frames, use_dino=use_dino,
                        use_depth=use_depth, device=device, seed=seed, **model_overrides)
    optimizer, schedule = create_optimizer(learning_rate, warmup_steps, total_steps)
    params = dict(model.named_parameters())
    state = TrainState(params=params, opt_state=optimizer.init(params), step=0)
    return state, model, optimizer, schedule
