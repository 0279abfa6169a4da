"""Train and eval steps (port of ``tdspa/train/step.py``).

A step computes the loss of a batch, its gradients by autograd and one
optimizer update; metrics are returned as device scalars under JAX's names
(``train/{loss,position_loss,visible_loss,learning_rate}``,
``eval/{loss,position_loss,visible_loss}``), so reading them is the only
synchronisation. The JAX steps take a ``mesh`` for data parallelism; the
port's ``torch.distributed`` counterpart is not written yet (ROADMAP.md
queue 1, item 7), so a mesh raises.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.train.losses import compute_loss_2d, compute_loss_3d


def _loss_fn(model):
    return compute_loss_3d if isinstance(model, TrackAutoEncoder3D) else compute_loss_2d


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= needs the port of tdspa/parallel over torch.distributed "
            "(ROADMAP.md queue 1, item 7)"
        )


def loss_and_grads(model, params: dict[str, torch.Tensor], batch) -> tuple[dict, list]:
    """(loss dict, gradients of the total loss w.r.t. ``params`` in their
    order); ``params`` must be ``model``'s own parameters."""
    loss_dict = _loss_fn(model)(model(batch), batch)
    grads = torch.autograd.grad(loss_dict["total_loss"], list(params.values()))
    return loss_dict, list(grads)


def _apply(state, optimizer, schedule, grads, losses):
    opt_state = optimizer.update(grads, state.opt_state, state.params)
    lr = schedule(state.step) if schedule is not None else 0.0
    metrics = {
        "train/loss": losses["total_loss"].detach(),
        "train/position_loss": losses["position_loss"].detach(),
        "train/visible_loss": losses["visible_loss"].detach(),
        "train/learning_rate": lr,
    }
    return state.replace(opt_state=opt_state, step=state.step + 1), metrics


def make_train_step(model, optimizer, schedule=None, mesh=None):
    """step(state, batch) -> (new_state, metrics): one update of ``model``'s
    parameters (``state.params``, updated in place)."""
    _no_mesh(mesh)

    def step(state, batch):
        losses, grads = loss_and_grads(model, state.params, batch)
        return _apply(state, optimizer, schedule, grads, losses)

    return step


def make_grad_accum_step(model, optimizer, schedule=None, num_microbatches: int = 8, mesh=None):
    """Training step with gradient accumulation over the batch axis.

    The batch is split into ``num_microbatches`` consecutive microbatches;
    each one's gradients are weighted by its clamped visible mass
    ``max(mass, 1)`` (which restores the raw numerator of its loss, the
    all-occluded microbatch's BCE term included) and the sum is divided by
    ``max(true total mass, 1)``: the full batch's gradient, so one update
    equals the full-batch step's. Peak activation memory is one
    microbatch's.
    """
    _no_mesh(mesh)
    m = num_microbatches

    def step(state, batch):
        b = next(iter(batch.values())).shape[0]
        if b % m != 0 or b < m:
            raise ValueError(
                f"batch size {b} must be a positive multiple of "
                f"num_microbatches={m} for gradient accumulation"
            )
        size = b // m
        grads_acc = None
        loss = pos = vis = den_total = 0.0
        for i in range(m):
            mb = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
            ld, grads = loss_and_grads(model, state.params, mb)
            mass = mb["query_tracks_visible"].float().sum()
            den = torch.clamp(mass, min=1.0)
            weighted = torch._foreach_mul(grads, den)
            if grads_acc is None:
                grads_acc = weighted
            else:
                torch._foreach_add_(grads_acc, weighted)
            del grads, weighted
            loss = loss + den * ld["total_loss"].detach()
            pos = pos + den * ld["position_loss"].detach()
            vis = vis + den * ld["visible_loss"].detach()
            den_total = den_total + mass
        den_total = torch.clamp(den_total, min=1.0)
        torch._foreach_div_(grads_acc, den_total)
        losses = {"total_loss": loss / den_total, "position_loss": pos / den_total,
                  "visible_loss": vis / den_total}
        return _apply(state, optimizer, schedule, grads_acc, losses)

    return step


def make_eval_step(model, mesh=None):
    """step(params, batch) -> (metrics, predictions), without gradients;
    ``params`` is a ``state_dict``-keyed dict (a ``TrainState``'s)."""
    _no_mesh(mesh)
    loss_fn = _loss_fn(model)

    @torch.no_grad()
    def step(params, batch):
        predictions = functional_call(model, params, (batch,))
        loss_dict = loss_fn(predictions, batch)
        metrics = {
            "eval/loss": loss_dict["total_loss"],
            "eval/position_loss": loss_dict["position_loss"],
            "eval/visible_loss": loss_dict["visible_loss"],
        }
        return metrics, predictions

    return step
