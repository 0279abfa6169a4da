"""Plain reference of the training step: the autoencoder's loss, its
gradients by autograd, then optax's ``chain(clip_by_global_norm(clip),
adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay))``: gradients whose
global norm is at or over ``clip`` are scaled to it; the moments are updated,
bias-corrected by 1 - b**count, and the update ``mu_hat / (sqrt(nu_hat) +
eps) + wd * p`` is applied with the step's rate, worked out from the
configuration's ``learning_rate``, ``warmup_steps`` and ``total_steps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import Model, loss

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def learning_rate(cfg: dict, step: int) -> float:
    """The rate of step ``step`` (counted from 0), in f32: linear from 0 over
    ``warmup_steps``, then a cosine from ``learning_rate`` to 0 over the rest
    of ``total_steps`` (at least one step)."""
    base, warmup = cfg["learning_rate"], cfg["warmup_steps"]
    if step < warmup:
        value = base * step / warmup
    else:
        decay = max(cfg["total_steps"] - warmup, 1)
        value = base * 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, decay) / decay))
    return float(np.float32(value))


def run_steps(cfg: dict, weights: dict, batches: list[dict], model_kwargs: dict | None = None,
              fault: str | None = None) -> dict:
    """Steps over ``batches`` from ``weights`` (left untouched), with the
    configuration's schedule, ``weight_decay`` and ``clip_norm``.

    Returns the loss of each step, the norm of each leaf's first gradient as
    the optimizer takes it (clipped), and the norm of each leaf's change after
    the last step. ``fault`` plants one of the faults the check must catch:
    ``"half_batch"`` (the loss over the first half of each batch alone) or
    ``"grad_doubled"`` (the largest leaf's gradient doubled where it is made).
    """
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    weight_decay, clip_norm = cfg["weight_decay"], cfg["clip_norm"]
    losses, first_grad = [], None
    for count, batch in enumerate(batches, start=1):
        rate = learning_rate(cfg, count - 1)
        if fault == "half_batch":
            half = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        model = Model(cfg, params, **(model_kwargs or {}))
        value = loss(cfg, model(batch), batch)
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        if fault == "grad_doubled":
            big = max(grads, key=lambda k: grads[k].numel())
            grads[big] = grads[big] * 2
        losses.append(float(value.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads.values()]))
            if not norm < clip_norm:
                grads = {k: g / norm * clip_norm for k, g in grads.items()}
            if first_grad is None:
                first_grad = leaf_norms(grads)
            bc1 = float(torch.tensor(1 - B1 ** count, dtype=torch.float32))
            bc2 = float(torch.tensor(1 - B2 ** count, dtype=torch.float32))
            for k, p in params.items():
                g = grads[k]
                mu[k].mul_(B1).add_(g * (1 - B1))
                nu[k].mul_(B2).add_(g * g * (1 - B2))
                update = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + EPS) + weight_decay * p
                p.sub_(rate * update)
        del grads, model
    with torch.no_grad():
        change = leaf_norms({k: params[k] - start[k] for k in params})
    return {"losses": losses, "first_grad": first_grad, "change": change}
